"""On the card: every cell's control comes out not correct and its sound
run correct, at a size a test run holds (`tools/control.py` reads the
same at each cell's own size). Each test decides inside itself whether a
card is there."""

import pytest

CELLS = {"chfak5.process": "process", "chfak1.process": "process",
         "chfak5.train_masker": "train_masker"}
CARD_SMALL = {
    "process": {"pool_frames": 4096, "batch": 1024},
    "train_masker": {"bank_frames": 512, "chunk_steps": 10},
}


def _readings(cell, kinds):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.tools.control import readings
    return list(readings(cell, [2 ** 31 + 21], kinds, 1.0,
                         CARD_SMALL[CELLS[cell]], "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_sound_passes(cell):
    sound, tf32, bf16 = _readings(cell, ["sound", "tf32", "bf16"])
    assert sound["correct"] is True, sound
    assert tf32["correct"] is False, tf32
    assert bf16["correct"] is False, bf16
