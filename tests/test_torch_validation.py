"""Periodic validation videos (training/validation.py, `LCDTrainer.run`'s
validation_fn / validation_every, `train_v1.build_validation_fn`) on the
CPU at the tiny shape.

- A run with validation takes the same draws, losses and LoRA factors as
  one without, and renders at every `validation_every`-th step.
- A render equals, bit for bit, a direct pipeline call with the student's
  weights and the prompt's seed, and leaves the student's train flags and
  the pipeline's own UNet as they were.
- The file container is the one asked for: `.mp4` without ffmpeg raises,
  and nothing else is written instead.
"""

import json
import os

import numpy as np
import pytest
import torch

from t2v_turbo_tpu.training import validation as jval
from t2v_turbo_tpu_torch.apps import train_v1
from t2v_turbo_tpu_torch.io import video as port_video
from t2v_turbo_tpu_torch.pipelines.vc2 import video_to_uint8
from t2v_turbo_tpu_torch.training import validation as V


def _trainer(out_dir, validation=True, max_steps=2):
    args = train_v1.parse_args(["--tiny-model", "--synthetic-data", "--random-weights", "--device", "cpu",
                                "--output-dir", str(out_dir), "--lora-rank", "4", "--max-steps", str(max_steps)])
    trainer, data, _ = train_v1.build_trainer(args, validation=validation)
    return args, trainer, data


def test_the_reference_prompts():
    assert V.DEFAULT_VALIDATION_PROMPTS == jval.DEFAULT_VALIDATION_PROMPTS
    assert len(V.DEFAULT_VALIDATION_PROMPTS) == 10


def test_validation_leaves_the_training_draws_alone(tmp_path):
    """3 steps rendering every 2nd (2 prompts at 1 sampling step) against 3
    steps of a trainer built without validation: step 3 follows a render,
    and every step's losses, the draws and the factors are the same;
    renders at step 2 only."""
    args, trainer, data = _trainer(tmp_path / "with", max_steps=3)
    fn = train_v1.build_validation_fn(args, trainer, max_prompts=2, step_counts=(1,), suffix=".npy")
    trainer.run(data, validation_fn=fn, validation_every=2)
    _, plain, plain_data = _trainer(tmp_path / "without", validation=False, max_steps=3)
    plain.run(plain_data)
    def losses(run_dir):
        return [(r["step"], r["loss"], r["distill_loss"]) for r in map(json.loads, open(run_dir / "metrics.jsonl"))]

    assert [r[0] for r in losses(tmp_path / "with")] == [1, 2, 3]
    assert losses(tmp_path / "with") == losses(tmp_path / "without")
    torch.testing.assert_close(trainer.flat, plain.flat, rtol=0, atol=0)
    assert torch.equal(trainer.generator.get_state(), plain.generator.get_state())
    index = [json.loads(line) for line in open(tmp_path / "with" / "validation" / "index.jsonl")]
    assert [(r["step"], r["sample_steps"], r["prompt"]) for r in index] == [
        (2, 1, V.DEFAULT_VALIDATION_PROMPTS[0]), (2, 1, V.DEFAULT_VALIDATION_PROMPTS[1])]
    for r in index:
        frames = np.load(r["path"])
        assert r["path"].endswith(".npy") and frames.shape == (4, 16, 16, 3) and frames.dtype == np.uint8
    assert not os.path.exists(tmp_path / "without" / "validation")


def test_render_equals_a_direct_pipeline_call(tmp_path):
    args, trainer, data = _trainer(tmp_path)
    trainer.step_once(next(data))  # the LoRA ups move off zero
    fn = train_v1.build_validation_fn(args, trainer, max_prompts=2, step_counts=(2,), suffix=".npy")
    # the render takes the trainer's own frozen models, not copies
    assert fn.pipe.vae is trainer.vae and fn.pipe.text_model is trainer.text_tower
    pipe, own_unet = fn.pipe, torch.nn.Identity()
    pipe.unet = own_unet
    trainer.student.train()
    grads = {n: p.requires_grad for n, p in trainer.student.named_parameters()}
    fn(7, trainer.student)
    assert pipe.unet is own_unet
    pipe.unet = trainer.student
    assert all(m.training for m in trainer.student.modules())
    assert grads == {n: p.requires_grad for n, p in trainer.student.named_parameters()}
    with torch.no_grad():
        direct = pipe(prompt=V.DEFAULT_VALIDATION_PROMPTS[1], height=16, width=16, frames=4,
                      num_inference_steps=2, generator=torch.Generator().manual_seed(1))
    got = np.load(tmp_path / "validation" / "step0000007_s2_p1.npy")
    np.testing.assert_array_equal(got, video_to_uint8(direct)[0])


def test_the_container_is_never_switched(tmp_path, monkeypatch):
    args, trainer, _ = _trainer(tmp_path)
    fn = train_v1.build_validation_fn(args, trainer, max_prompts=1, step_counts=(1,), suffix=".mp4")
    monkeypatch.setattr(port_video.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no ffmpeg"):
        fn(1, trainer.student)
    assert os.listdir(tmp_path / "validation") == []
    with pytest.raises(ValueError, match=".gif"):
        V.make_validation_logger(fn.pipe, str(tmp_path), suffix=".gif")


def test_validation_needs_the_trainer_built_for_it(tmp_path):
    """Without validation=True a synthetic trainer holds no VAE or text
    tower, and build_validation_fn refuses it rather than build copies."""
    args, trainer, _ = _trainer(tmp_path, validation=False)
    assert trainer.vae is None and trainer.text_tower is None
    with pytest.raises(ValueError, match="validation=True"):
        train_v1.build_validation_fn(args, trainer, max_prompts=1, step_counts=(1,), suffix=".npy")
