"""PyTorch port: the N-seed runner (`cgs_tpu_torch/sandbox/multirun.py`)
against the JAX package's (`cgs_tpu/sandbox/multirun.py`).

`cli.main` is replaced in both packages by a stub that returns a
handler with a fixed IoU per seed, so the runners' own logic (argv,
run names, aggregation, the `results.txt` line) is compared with no
training; the line must be equal byte for byte.
"""

import pytest

import cgs_tpu.cli as jax_cli
import cgs_tpu.sandbox.multirun as jax_multirun
import cgs_tpu_torch.cli as port_cli
from cgs_tpu_torch.sandbox import multirun

IOUS = {3: 0.71234, 4: 0.6, 5: 0.80551, 6: 0.0004}


class _Handler:
    def __init__(self, argv):
        self.argv = argv
        seed = int(argv[argv.index("--seed") + 1])
        self.last_ious = [IOUS[seed], 0.5] if seed != 6 else []
        self.ious = (IOUS[seed], 0.0)
        self.closed = False

    def close(self):
        self.closed = True


def _stub(calls):
    def main(argv, primary=True):
        calls.append((list(argv), primary))
        return _Handler(argv)
    return main


@pytest.mark.parametrize("argv, value, rest", [
    (["-train", "--runs", "5", "-eval"], 5, ["-train", "-eval"]),
    (["--runs=7", "--model", "m"], 7, ["--model", "m"]),
    (["-eval"], 1, ["-eval"]),
])
def test_pop_int_takes_both_spellings(argv, value, rest):
    jargv = list(argv)
    assert multirun.pop_runs(argv) == value == jax_multirun.pop_runs(jargv)
    assert argv == rest == jargv


def test_pop_int_missing_value_exits():
    with pytest.raises(SystemExit, match="--runs requires a value"):
        multirun.pop_int(["-eval", "--runs"], "--runs", 1)
    assert multirun.pop_int(["--base-seed", "3"], "--base-seed", 0) == 3


@pytest.mark.parametrize("argv", [["--model", "abc", "-eval"],
                                  ["--model=abc"], ["-eval"],
                                  ["--model", "a", "--model=b"]])
def test_seeded_name_matches_jax(argv):
    assert multirun._seeded_name(argv, 4) == \
        jax_multirun._seeded_name(argv, 4)
    assert multirun._seeded_name(argv, 4).endswith("-seed4")


@pytest.mark.parametrize("base_seed, runs", [(3, 3), (4, 3)])
def test_results_line_equals_jax_byte_for_byte(tmp_path, monkeypatch,
                                               base_seed, runs):
    argv = ["-train", "-eval", "-synthetic_data", "--model", "mr"]
    ours, theirs = [], []
    monkeypatch.setattr(port_cli, "main", _stub(ours))
    monkeypatch.setattr(jax_cli, "main",
                        lambda argv: _stub(theirs)(argv, None))
    seen = []
    got = multirun.run_seeds(
        argv, runs, results_path=str(tmp_path / "ours.txt"),
        base_seed=base_seed, primary=False,
        on_seed=lambda seed, h: seen.append((seed, h.closed)))
    want = jax_multirun.run_seeds(
        argv, runs, results_path=str(tmp_path / "theirs.txt"),
        base_seed=base_seed)
    assert got == want
    line = (tmp_path / "ours.txt").read_bytes()
    assert line == (tmp_path / "theirs.txt").read_bytes()
    assert line.startswith(b"runs=3 args=-train -eval -synthetic_data "
                           b"--model mr ious=[")
    # the same argv per seed, run names {model}-seed{s}, primary passed
    assert [a for a, _ in ours] == [a for a, _ in theirs]
    assert [p for _, p in ours] == [False] * runs
    assert [a[-1] for a, _ in ours] == [f"mr-seed{s}" for s in
                                        range(base_seed, base_seed + runs)]
    # on_seed sees each handler before it is closed
    assert seen == [(s, False) for s in range(base_seed, base_seed + runs)]


def test_results_line_appends(tmp_path, monkeypatch):
    monkeypatch.setattr(port_cli, "main", _stub([]))
    path = str(tmp_path / "results.txt")
    multirun.run_seeds(["-eval"], 1, results_path=path, base_seed=3)
    multirun.run_seeds(["-eval"], 2, results_path=path, base_seed=4)
    lines = (tmp_path / "results.txt").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == ["runs=1", "runs=2"]
    assert "ious=[0.712] mean=0.712 std=0.000 best=0.712" in lines[0]


def test_main_pops_runs_and_runs_on_the_default_device(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(port_cli, "main", _stub(calls))
    monkeypatch.setattr(multirun, "run_seeds",
                        lambda argv, runs: calls.append((argv, runs)))
    multirun.main(["--runs=4", "-eval", "--model", "m"])
    assert calls == [(["-eval", "--model", "m"], 4)]
    # no --device in argv: cli.main runs on cuda, its default
    assert port_cli.parse_args(calls[0][0]).device == "cuda"
