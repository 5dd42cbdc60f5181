"""PyTorch port: `python -m cgs_tpu_torch.cli --device cpu
--data-parallel 2 -train -eval -synthetic_data` (two gloo ranks), at a
small size, as `tests/test_dp_product.py:26-79` runs the JAX CLI over a
mesh: both ranks end with bit-identical parameters, only rank 0 writes
files, and the hard masks of the trained models match the port's own
world-1 run pixel for pixel (DP sums each batch's mean in another
order, and over a run that rounding moves the soft masks by ~6e-4 on
this fixture; the JAX test allows 0.5% of the pixels to flip).
`cli.main` starting its own ranks gives the world-1 eval's IoU.
"""

import numpy as np
import torch

from cgs_tpu_torch import cli
from cgs_tpu_torch.parallel import multihost, probes
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

ARGS = ["--device", "cpu", "-train", "-eval", "-synthetic_data",
        "--datasize", "1100", "--testsize", "100", "--cepochs", "6",
        "--batch-size", "32", "--dropout", "0", "--high-rew-thresh",
        "0.55", "--low-rew-thresh", "0.45", "--contrastive-min", "5",
        "--mepochs", "1", "--visevery", "40", "--model", "dp"]


def test_cli_two_ranks_train_eval(tmp_path, one_torch_thread):
    dirs = [tmp_path / f"rank{r}" for r in range(3)]
    for d in dirs:
        d.mkdir()
    got = multihost.launch(
        probes.cli_run, 2, (ARGS + ["--data-parallel", "2"],
                            [str(d) for d in dirs[:2]]),
        device="cpu", gather=True, timeout_s=120.0, join_s=60.0)
    one = probes.cli_run(ARGS + ["--data-parallel", "1"], [str(dirs[2])],
                         meshed=False)
    for name in got[0]["params"]:
        for k, v in got[0]["params"][name].items():
            assert torch.equal(v, got[1]["params"][name][k]), (name, k)
    assert got[0]["ious"] == got[1]["ious"]
    assert got[1]["files"] == []
    assert got[0]["files"] == one["files"]
    assert any(f.startswith("dp/saves/masker-") for f in got[0]["files"])
    hard2, hard1 = got[0]["hard"], one["hard"]
    np.testing.assert_array_equal(hard2, hard1)
    np.testing.assert_allclose(got[0]["masks"], one["masks"], atol=1e-2)


def test_cli_starts_its_own_ranks(tmp_path, monkeypatch, one_torch_thread):
    """cli.main with --data-parallel 2 and no launcher around it becomes
    rank 0 of a world it starts, and returns rank 0's Handler; an eval
    of random weights gives the world-1 IoU."""
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "-eval", "-synthetic_data", "--model", "e"]
    h2 = cli.main(argv + ["--data-parallel", "2"], primary=False)
    h1 = cli.main(argv + ["--data-parallel", "1"], primary=False)
    assert h2.mesh is not None and h2.mesh.shape == {"data": 2}
    assert h2.mesh.rank == 0 and h1.mesh is None
    assert h2.last_ious == h1.last_ious
    assert not multihost.joined()
    assert list(tmp_path.iterdir()) == []


def test_cli_process_over_two_ranks(tmp_path, monkeypatch, one_torch_thread):
    """-process of 9 frames (a batch padded to an even 10) over two
    ranks writes the world-1 run's PNGs: the raw masks within one level
    (each rank's convolutions see 5 frames, not 9), the thresholded
    ones equal wherever the raw level is not at the threshold."""
    from PIL import Image

    from cgs_tpu_torch.data.synthetic import synthetic_eval_set

    monkeypatch.chdir(tmp_path)
    src = tmp_path / "src"
    src.mkdir()
    frames, _ = synthetic_eval_set(n_frames=9, seed=5)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(src / f"img{i:03d}.png")
    outs = {}
    for world in (2, 1):
        out = tmp_path / f"out{world}"
        cli.main(["--device", "cpu", "-process", "--source-imgs", str(src),
                  "--mask-output-imgs", str(out), "--model", "p",
                  "--data-parallel", str(world)])
        outs[world] = {p.name: np.asarray(Image.open(p)).astype(int)
                       for p in sorted(out.iterdir())}
    assert outs[2].keys() == outs[1].keys() and len(outs[1]) == 18
    for name, a in outs[2].items():
        b = outs[1][name]
        if name.endswith("-raw-mask.png"):
            assert np.abs(a - b).max() <= 1, name
        else:
            raw = outs[1][name.replace("thresholded", "raw")]
            flipped = (a != b).any(-1)
            assert np.isin(raw[flipped][:, 0], (127, 128)).all(), name
