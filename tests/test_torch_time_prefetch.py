"""apps/time_prefetch.py, the card's timing of the trainer's input path,
rehearsed on the CPU at the tiny size: its seeded decoded clips, and a
whole run against another trainer module's `run` (here the port's own),
whose losses it requires to be equal.
"""

import itertools

import numpy as np

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu_torch.apps import time_prefetch
from t2v_turbo_tpu_torch.training import trainer as trainer_mod


def test_decoded_clips_are_seeded_crops():
    """time_prefetch.decoded_clips: batches of one clip in [-1, 1] at the
    crop size, the captions in turn, the same for every call."""
    a, b = (list(itertools.islice(time_prefetch.decoded_clips(3, (32, 48)), 5)) for _ in range(2))
    assert [x["txt"] for x in a] == [[time_prefetch.CAPTIONS[i % 4]] for i in range(5)]
    for x, y in zip(a, b):
        assert x["video"].shape == (1, 3, 32, 48, 3) and x["video"].dtype == np.float32
        assert -1.0 <= x["video"].min() and x["video"].max() <= 1.0
        np.testing.assert_array_equal(x["video"], y["video"])


def test_runs_against_a_baseline_module_on_the_cpu(capsys):
    assert time_prefetch.main(["--baseline-trainer", trainer_mod.__file__, "--device", "cpu", "--tiny-model",
                               "--steps", "2"]) == 0
    out = capsys.readouterr().out
    for source in ("synthetic", "real"):
        assert f"{source}: the two runs' losses equal" in out
        assert sum(line.startswith(f"{source} baseline: s/step") for line in out.splitlines()) == 2
        assert sum(line.startswith(f"{source} this    : s/step") for line in out.splitlines()) == 2
    assert "alone: host resize and crop of a batch" in out
