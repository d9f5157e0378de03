"""The port's v1 LoRA LCD trainer (training/trainer.py) and its CLI
(apps/train_v1.py), on the CPU at --tiny-model size: steps, checkpoint
rotation and resume, remat, gradient accumulation, the exports, and training
with both rewards. The JAX-parity LCD steps are in tests/test_torch_training.py
and tests/test_torch_reward_training.py; these run in their own file so that
xdist spreads them beside those files' JAX compiles.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu_torch import lora as L
from t2v_turbo_tpu_torch.apps import train_v1


def _tiny_args(out_dir, *extra):
    return train_v1.parse_args(["--tiny-model", "--synthetic-data", "--random-weights", "--device", "cpu",
                                "--output-dir", str(out_dir), "--lora-rank", "4", *extra])


def test_trainer_checkpoints_resume_and_isolation(tmp_path):
    args = _tiny_args(tmp_path, "--max-steps", "4", "--checkpointing-steps", "2",
                      "--checkpoints-total-limit", "2", "--learning-rate", "1e-3")
    trainer, data, _ = train_v1.build_trainer(args)
    base0 = {k: v.clone() for k, v in L.base_state_dict(trainer.student).items()}
    teacher0 = {k: v.clone() for k, v in trainer.teacher.state_dict().items()}
    fac0 = {n: {k: t.detach().clone() for k, t in f.items()} for n, f in trainer.factors.items()}
    assert all(float(f["up"].abs().max()) == 0 for f in fac0.values())
    metrics = trainer.run(data)
    assert metrics["step"] == 4 and np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    assert [s for s, _ in trainer._checkpoints()] == [2, 4]
    rows = [l for l in open(os.path.join(tmp_path, "metrics.jsonl"))]
    assert len(rows) == 4 and all('"time_per_step_s"' in r and '"data_wait_frac"' in r for r in rows)
    base1 = L.base_state_dict(trainer.student)
    assert all(torch.equal(base1[k], base0[k]) for k in base0)  # the base is frozen
    assert all(torch.equal(v, teacher0[k]) for k, v in trainer.teacher.state_dict().items())
    for n, f in trainer.factors.items():  # every factor moved
        assert not torch.equal(f["up"], fac0[n]["up"]) and not torch.equal(f["down"], fac0[n]["down"]), n

    resumed, data2, _ = train_v1.build_trainer(
        _tiny_args(tmp_path, "--max-steps", "5", "--checkpointing-steps", "2",
                   "--checkpoints-total-limit", "2"))
    assert resumed.resume_if_available() == 4
    for n, f in trainer.factors.items():
        for k in ("down", "up"):
            assert torch.equal(resumed.factors[n][k], f[k])
    assert resumed.optimizer.count == trainer.optimizer.count == 4
    assert resumed.run(data2)["step"] == 5
    assert [s for s, _ in resumed._checkpoints()] == [4, 5]
    # export: base + collapsed factors
    merged = resumed.export_student_params()
    assert set(merged) == set(base0)


def test_trainer_with_remat_takes_the_same_steps(tmp_path):
    """--use-remat recomputes the blocks in the backward, reading the step's
    merged weights: the same losses and factors as without it."""
    runs = []
    for remat in (False, True):
        args = _tiny_args(tmp_path / str(remat), "--max-steps", "2", *(["--use-remat"] if remat else []))
        trainer, data, _ = train_v1.build_trainer(args)
        losses = [float(trainer.step_once(next(data))["loss"]) for _ in range(2)]
        runs.append((losses, trainer.flat.clone()))
    assert runs[1][0] == pytest.approx(runs[0][0], rel=1e-6)
    torch.testing.assert_close(runs[1][1], runs[0][1], atol=1e-7, rtol=0)


def test_grad_accumulation_updates_every_k_micro_steps(tmp_path):
    args = _tiny_args(tmp_path, "--max-steps", "3", "--gradient-accumulation-steps", "2",
                      "--checkpointing-steps", "100")
    trainer, data, _ = train_v1.build_trainer(args)
    snap = lambda: [p.detach().clone() for p in trainer.params]
    p0 = snap()
    trainer.step_once(next(data))
    assert trainer.optimizer.count == 0 and all(torch.equal(a, b) for a, b in zip(p0, snap()))
    trainer.step_once(next(data))
    assert trainer.optimizer.count == 1 and any(not torch.equal(a, b) for a, b in zip(p0, snap()))


def test_cli_trains_and_exports(tmp_path):
    from t2v_turbo_tpu.lora import load_lora_npz as jax_load_npz

    train_v1.main(["--tiny-model", "--synthetic-data", "--random-weights", "--max-steps", "2",
                   "--device", "cpu", "--output-dir", str(tmp_path)])
    assert os.path.exists(tmp_path / "checkpoints" / "step_00000002.pt")
    flat = jax_load_npz(str(tmp_path / "unet_lora.npz"))
    weights = torch.load(tmp_path / "unet_lora.pt", weights_only=True)
    assert len(weights) == 2 * len(flat) == 2 * 248
    assert weights[1].shape[0] == 64  # rank 64 down factor first pair (up, down)


def test_cli_trains_with_both_rewards(tmp_path):
    train_v1.main(["--tiny-model", "--synthetic-data", "--random-weights", "--max-steps", "2", "--device", "cpu",
                   "--output-dir", str(tmp_path), "--lora-rank", "4", "--reward-fn", "hpsv2",
                   "--video-rm-fn", "vi_clip"])
    rows = [json.loads(line) for line in open(os.path.join(tmp_path, "metrics.jsonl"))]
    assert len(rows) == 2
    for row in rows:
        assert np.isfinite(row["reward_loss"]) and np.isfinite(row["video_rm_loss"])
        assert row["loss"] == pytest.approx(row["distill_loss"] + row["reward_loss"] + row["video_rm_loss"],
                                            rel=1e-5)
