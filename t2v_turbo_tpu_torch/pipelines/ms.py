"""T2V-Turbo (ModelScope) prompt -> video (port of t2v_turbo_tpu/pipelines/ms.py;
the reference's pipeline/t2v_turbo_ms_pipeline.py:15-221).

The VC2 pipeline's LCM loop, prompt encoding and frame-by-frame decode with
the MS UNet (models/unet_ms.py) as the denoiser: it takes the w-embedding
alone (no fps, no motion conditioning; the reference :186-200), and the
operating point is 16 frames at 256x256 (the defaults when the call gives
no size). The text tower is the full-depth CLIP tower of the MS folder
(penultimate off).
"""

from __future__ import annotations

import dataclasses

from .vc2 import T2VTurboVC2Pipeline


@dataclasses.dataclass
class T2VTurboMSPipeline(T2VTurboVC2Pipeline):
    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError("the MS pipeline takes no mesh, as JAX's takes none: sharded sampling and the "
                                      "model axis (A12b.2; its training half is A12b.2b) run the VC2 UNet")
        super().__post_init__()

    def _levels(self) -> int:
        return len(self.unet.cfg.block_out_channels)

    def _unet_kwargs(self, fps, w_emb, **kw):
        if kw:
            raise ValueError(f"the MS UNet takes no {sorted(kw)}")
        return dict(timestep_cond=w_emb)

    def __call__(self, *args, **kwargs):
        kwargs.setdefault("height", 256)
        kwargs.setdefault("width", 256)
        return super().__call__(*args, **kwargs)
