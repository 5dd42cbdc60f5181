"""PyTorch port: the HTTP mask server over two ranks
(`cgs_tpu_torch/serve.py --data-parallel 2`: rank 0 serves, rank 1 a
spawned `serve_worker`, gloo on the CPU), against the JAX server and the
port's one-rank server on one `.pt` run dir written by the port's
`save_model_pt` from JAX params; the seed-sharded `--ensemble 2`; a
`/reload` under concurrent traffic, every dispatch (both ranks' rows)
on one weight set; a dead worker failing its requests in seconds.

On the CPU at chfak 1, batch 8 (4 rows a rank). Tolerances: soft masks
within 1e-5 of the one-rank server's (each rank runs 4 of the 8 rows:
the convolutions sum in other orders); PNGs against the JAX server's
within one level and identical on >= 99.9% of pixels; thresholded
identical away from the threshold (1e-5).
"""

import io
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
from PIL import Image

from cgs_tpu.core.config import parse_args as jax_parse_args
from cgs_tpu.serve import MaskServer as JaxServer
from cgs_tpu_torch.core.config import parse_args
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.serve import MaskServer, ServerError
from cgs_tpu_torch.train.checkpoints import checkpoint_paths, save_model_pt
from torch_port_common import jax_models, port_params

TOL = 1e-5


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _levels(png):
    return np.asarray(Image.open(io.BytesIO(png))).astype(np.int16)


def _argv(run, *extra):
    return ["--infer-batch", "8", "--serve-wait-ms", "5", "--model", run,
            *extra]


def _publish(params, run_argv):
    paths = checkpoint_paths(parse_args(run_argv + ["--device", "cpu"]))
    os.makedirs(os.path.dirname(paths["critic"]), exist_ok=True)
    for name in ("critic", "masker"):
        save_model_pt(params[name], name, paths[name])


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A run dir of seed 3's JAX weights, the JAX server and the port's
    one-rank server on it. A process holds one served world at a time,
    so each test starts its two-rank server after its one-rank ones and
    shuts it down before it ends."""
    run = str(tmp_path_factory.mktemp("dp") / "run")
    _publish(port_params(jax_models(seed=3)[2]), _argv(run))
    jsrv = JaxServer(jax_parse_args(_argv(run)))
    one = MaskServer(parse_args(_argv(run, "--device", "cpu")))
    yield run, jsrv, one
    for s in (jsrv, one):
        s.batcher.close()


def _two(run, *extra):
    """A two-rank server whose collectives give up after 60 s."""
    return MaskServer(parse_args(_argv(run, "--device", "cpu",
                                       "--data-parallel", "2", *extra)),
                      timeout_s=60.0)


def test_two_ranks_answer_as_one_rank_and_as_jax(base, rng):
    run, jsrv, one = base
    two = _two(run)
    try:
        _answers(jsrv, one, two, rng)
        _coalesces_and_reports(one, two, rng)
    finally:
        two.shutdown()


def _answers(jsrv, one, two, rng):
    assert two.world == 2 and two.pipe.batch == 8
    frames = rng.integers(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    same = total = 0
    for frame in frames:
        soft1 = one.batcher.submit(frame).mask
        soft2 = two.batcher.submit(frame).mask
        np.testing.assert_allclose(soft2, soft1, atol=TOL, rtol=0)
        body = _png(frame)
        j, p = _levels(jsrv.segment_bytes(body)), _levels(
            two.segment_bytes(body))
        assert np.abs(j - p).max() <= 1
        same += int((j == p).sum())
        total += j.size
        far = np.abs(soft1 - 0.5) > TOL
        jt = _levels(jsrv.segment_bytes(body, variant="thresholded",
                                        threshold=0.5))
        pt = _levels(two.segment_bytes(body, variant="thresholded",
                                       threshold=0.5))
        np.testing.assert_array_equal(jt[far], pt[far])
    assert same / total >= 0.999


def _coalesces_and_reports(one, two, rng):
    frames = rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    d0 = two.batcher.stats["dispatches"]
    out = [None] * 8

    def go(i):
        out[i] = two.batcher.submit(frames[i]).mask

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert two.batcher.stats["dispatches"] - d0 < 8
    want = one.pipe.run(frames).masks[..., 0]
    np.testing.assert_allclose(np.stack(out), want, atol=TOL, rtol=0)
    httpd = two.start(port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        two.httpd = None
    assert stats["world"] == 2 and stats["status"] == "ok"
    assert "world" not in health and health["status"] == "ok"


def test_ensemble_two_seed_sharded(tmp_path, rng):
    """--ensemble 2 over 2 ranks: one member a rank, the masks summed
    over the ranks, equal to the one-rank ensemble."""
    base = str(tmp_path / "ens")
    for s in (0, 1):
        _publish(port_params(jax_models(seed=10 + s)[2]),
                 _argv(f"{base}-seed{s}"))
    one = MaskServer(parse_args(_argv(base, "--device", "cpu",
                                      "--ensemble", "2")))
    two = _two(base, "--ensemble", "2")
    try:
        assert len(two.pipe._members) == 1 and len(one.pipe._members) == 2
        for frame in rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8):
            np.testing.assert_allclose(two.batcher.submit(frame).mask,
                                       one.batcher.submit(frame).mask,
                                       atol=1e-6, rtol=0)
    finally:
        one.batcher.close()
        two.shutdown()


def test_reload_under_traffic_swaps_both_ranks_at_one_boundary(tmp_path,
                                                               rng):
    """Clients post while two weight sets are published and reloaded in
    turn: every dispatch's whole batch, both ranks' rows, is one set's,
    and after a reload returns the new set answers."""
    run = str(tmp_path / "run")
    argv = _argv(run, "--device", "cpu", "--data-parallel", "2")
    sets = [port_params(jax_models(seed=s)[2]) for s in (4, 5)]
    _publish(sets[0], argv)
    srv = MaskServer(parse_args(argv), timeout_s=60.0)
    real = srv.pipe.run_device
    dispatched = []

    def recording(x):
        out = real(x)
        dispatched.append((x.numpy().copy(), out[1].numpy().copy()))
        return out

    srv.pipe.run_device = recording
    try:
        pipes = [MaskPipeline(srv.pipe.critic, srv.pipe.masker, p,
                              batch_size=8, device="cpu") for p in sets]
        frames = rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8)
        errors, done = [], threading.Event()

        def client(i):
            try:
                for k in range(5):
                    srv.batcher.submit(frames[(i + k) % 16])
            except Exception as e:
                errors.append(repr(e))

        def reloader():
            j = 0
            while not done.is_set():
                j += 1
                _publish(sets[j % 2], argv)
                srv.reload_checkpoints()

        rt = threading.Thread(target=reloader)
        rt.start()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(120)
        done.set()
        rt.join(120)
        assert not errors, errors
        assert srv.reloads >= 2 and len(dispatched) > 2
        for x, mask in dispatched:
            gaps = [float(np.abs(p.run(x).masks - mask).max())
                    for p in pipes]
            assert min(gaps) <= TOL, f"a dispatch of neither set: {gaps}"
        for which in (1, 0):
            _publish(sets[which], argv)
            srv.reload_checkpoints()
            got = srv.batcher.submit(frames[3]).mask
            want = pipes[which].run(frames[3:4]).masks[0, ..., 0]
            np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    finally:
        srv.shutdown()


def test_a_dead_worker_fails_the_requests_in_seconds(tmp_path, rng):
    srv = _two(str(tmp_path / "run"))
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    try:
        assert srv.batcher.submit(frame).mask.shape == (64, 64)
        worker = srv._ranks.procs[0]
        worker.kill()
        worker.join(10)
        t0 = time.perf_counter()
        with pytest.raises(ServerError):
            srv.batcher.submit(frame, timeout=60)
        assert time.perf_counter() - t0 < 30
        assert srv.batcher._dispatch_dead.wait(10)
        assert srv.batcher.broken is not None
        with pytest.raises(ServerError, match="not serving"):
            srv.batcher.submit(frame, timeout=60)
    finally:
        srv.shutdown()


def test_default_serves_on_one_rank_whatever_the_cards(monkeypatch):
    """No --data-parallel, and --data-parallel 1, serve on one rank even
    on a host that shows four cards: the server starts no rank. (The
    CLI's default, every card, is not the server's.) --data-parallel 2
    starts a world of two."""
    import torch

    import cgs_tpu_torch.serve as serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    started = []
    monkeypatch.setattr(serve.multihost, "start",
                        lambda fn, n, *a, **k: started.append(n) or "ranks")
    for extra in ([], ["--data-parallel", "1"]):
        assert serve._serve_world(parse_args(["--model", "x", *extra])) == (
            None, None)
    assert started == []
    assert serve._serve_world(parse_args(
        ["--model", "x", "--data-parallel", "2"])) == (None, "ranks")
    assert started == [2]
