"""The v1 trainer under preemption, on the CPU at the tiny shape.

- `apps/soak_v1.py --tiny`: x264 tar shards written by the port's encoder,
  `apps.train_v1` run as a subprocess on them (native decode, tiny VAE
  encode, the LCD step), SIGTERM once it has logged its first steps, the
  graceful final checkpoint, a relaunch, and the run resuming at that
  checkpoint's step + 1.
- In process: a SIGTERM that lands while the prefetcher's worker is
  inside an encode ends `run` in the checkpoint of the last finished step,
  not in a re-raised error.
"""

import json
import os
import signal
import time

import numpy as np

from t2v_turbo_tpu_torch.apps import soak_v1, train_v1


def test_soak_tiny_sigterm_resume(tmp_path):
    summary = soak_v1.main(["--workdir", str(tmp_path), "--tiny", "--phase-a-s", "0", "--phase-b-s", "0",
                            "--n-shards", "2", "--clips-per-shard", "4", "--deadline-s", "120",
                            # more than the steps reached: the final save must come from SIGTERM
                            "--checkpointing-steps", "50"])
    assert summary == json.loads((tmp_path / "summary.json").read_text())
    assert summary["ckpt_phase_a"] >= 2
    assert summary["resumed_at_step"] == summary["ckpt_phase_a"] + 1
    assert summary["steps_total"] > summary["resumed_at_step"]
    assert 0.0 <= summary["data_wait_frac"] <= 1.0
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in rows]
    assert steps == list(range(1, summary["ckpt_phase_a"] + 1)) + list(range(summary["resumed_at_step"],
                                                                             summary["steps_total"] + 1))
    assert all("data_wait_frac" in r and np.isfinite(r["loss"]) for r in rows)


def test_sigterm_during_an_encode_ends_in_the_checkpoint(tmp_path):
    args = train_v1.parse_args(["--tiny-model", "--synthetic-data", "--random-weights", "--device", "cpu",
                                "--output-dir", str(tmp_path), "--lora-rank", "4", "--max-steps", "100",
                                "--checkpointing-steps", "1000"])
    trainer, data, _ = train_v1.build_trainer(args)

    def encoding():
        for i, batch in enumerate(data):
            if i == 3:  # the worker, inside its fourth "encode", is signalled
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(0.5)
            yield batch

    handler = signal.getsignal(signal.SIGTERM)
    trainer.run(encoding())
    assert 1 <= trainer.step <= 4  # the worker runs at most two batches ahead
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [f"step_{trainer.step:08d}.pt"]
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == list(range(1, trainer.step + 1))
    assert signal.getsignal(signal.SIGTERM) is handler


def test_the_full_shape_is_train_v1s_own():
    """Without --tiny the soak passes train_v1 no shape, optimizer or rank:
    the trainer's defaults govern; --tiny appends the tiny CPU shape."""
    full = soak_v1.train_cmd(soak_v1.parse_args(["--workdir", "w"]), "w/run")
    tiny = soak_v1.train_cmd(soak_v1.parse_args(["--workdir", "w", "--tiny"]), "w/run")
    assert tiny == full + soak_v1.TINY_TRAIN_FLAGS
    args, defaults = train_v1.parse_args(full[3:]), train_v1.parse_args([])
    for k in ("height", "width", "n_frames", "optimizer", "lora_rank", "seed", "device"):
        assert getattr(args, k) == getattr(defaults, k), k
