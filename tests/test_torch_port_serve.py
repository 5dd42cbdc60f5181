"""PyTorch port: the HTTP mask server (`cgs_tpu_torch/serve.py`), each
case of tests/test_serve.py on the port, plus what the port adds: the
`--data-parallel 2` server, the uneven ensemble served unmeshed and the
no-card raise,
reloads under traffic that never serve a torn batch (every response is
the old or the new weights' mask), and a JAX `MaskServer` and a port
`MaskServer` answering
the same PNGs from one `.pt` run dir written by the port's
`save_model_pt` from JAX params. Serving over two ranks has its own
file, tests/test_torch_port_serve_dp.py.

On the CPU at chfak 1, batch 8. Parity tolerances: raw PNGs within one
level and identical on >= 99.9% of pixels (the two packages' f32 convs
sum in other orders); thresholded PNGs identical except where the soft
mask lies within 1e-5 of the threshold.
"""

import concurrent.futures as cf
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from cgs_tpu.core.config import parse_args as jax_parse_args
from cgs_tpu.serve import MaskServer as JaxServer
from cgs_tpu.train.checkpoints import checkpoint_paths as jax_ckpt_paths
from cgs_tpu_torch import serve
from cgs_tpu_torch.core.config import Config, parse_args
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.interop import init_torch_default
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.serve import MaskServer, MicroBatcher, ServerError, _Request
from cgs_tpu_torch.train.checkpoints import checkpoint_paths, save_model_pt
from torch_port_common import jax_models, port_params

ARGS = ["--infer-batch", "8", "--device", "cpu"]


def _png(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _levels(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png))).astype(np.int16)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    cfg = parse_args(ARGS + ["--serve-wait-ms", "30", "--model",
                             str(tmp_path_factory.mktemp("srv") / "norun")])
    srv = MaskServer(cfg)
    yield srv
    srv.batcher.close()


@pytest.fixture
def http(server):
    """The fixture server's HTTP front on a free port; its base URL."""
    httpd = server.start(port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def test_default_coalescing_window_is_2ms():
    import inspect
    assert Config().serve_wait_ms == 2.0
    sig = inspect.signature(MicroBatcher.__init__)
    assert sig.parameters["max_wait_ms"].default == 2.0


def test_segment_bytes_raw_and_thresholded(server, rng):
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    out = Image.open(io.BytesIO(server.segment_bytes(_png(frame))))
    assert out.size == (64, 64) and out.mode == "L"
    png = server.segment_bytes(_png(frame), variant="thresholded",
                               threshold=0.5)
    assert set(np.unique(_levels(png)).tolist()) <= {0, 255}


def test_wrong_size_rejected_unless_resize(server, rng):
    frame = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="64x64"):
        server.segment_bytes(_png(frame))
    png = server.segment_bytes(_png(frame), resize=True)
    assert Image.open(io.BytesIO(png)).size == (48, 32)


def test_microbatch_coalesces_concurrent_requests(server, rng):
    frames = rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    d0 = server.batcher.stats["dispatches"]
    results = [None] * 8

    def go(i):
        results[i] = server.batcher.submit(frames[i])

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert all(r.mask.shape == (64, 64) for r in results)
    dispatches = server.batcher.stats["dispatches"] - d0
    assert dispatches < 8, f"no coalescing: {dispatches} dispatches"
    a = server.batcher.submit(frames[0])
    np.testing.assert_allclose(a.mask, results[0].mask, atol=1e-6)


def test_http_surface(server, http, rng):
    with urllib.request.urlopen(f"{http}/healthz") as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["batch"] == 8
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    req = urllib.request.Request(
        f"{http}/segment?variant=thresholded&threshold=0.4",
        data=_png(frame), method="POST")
    with urllib.request.urlopen(req) as r:
        assert r.headers["Content-Type"] == "image/png"
        assert Image.open(io.BytesIO(r.read())).size == (64, 64)
    req = urllib.request.Request(f"{http}/segment?variant=nope",
                                 data=_png(frame), method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 400
    small = _png(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    req = urllib.request.Request(f"{http}/segment", data=small,
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 400
    req = urllib.request.Request(f"{http}/segment?resize=1", data=small,
                                 method="POST")
    with urllib.request.urlopen(req) as r:
        assert Image.open(io.BytesIO(r.read())).size == (32, 32)


def test_malformed_body_gets_400_not_connection_reset(http):
    req = urllib.request.Request(f"{http}/segment",
                                 data=b"this is not an image", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 400


def test_threshold_boundary_matches_offline_process(server, rng):
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    soft = server.batcher.submit(frame).mask
    exact = float(soft[7, 9])
    png = server.segment_bytes(_png(frame), variant="thresholded",
                               threshold=exact)
    assert _levels(png)[7, 9] == 255


def test_batch_failure_fails_requests_but_not_the_server(server, rng):
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    pipe = server.batcher.pipeline
    calls = {"n": 0}

    def boom(frames):
        calls["n"] += 1
        raise RuntimeError("injected device failure")

    pipe.run_device = boom
    try:
        with pytest.raises(ServerError, match="injected"):
            server.batcher.submit(frame, timeout=10)
    finally:
        del pipe.run_device
    assert calls["n"] == 1
    assert server.batcher.stats["errors"] >= 1
    assert server.batcher.submit(frame, timeout=30).mask.shape == (64, 64)


def test_readback_failure_fails_the_batch_not_the_thread(server, rng):
    """A device error surfaces at the readback: the completion thread
    fails that batch and keeps serving."""
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    pipe = server.batcher.pipeline
    real = pipe.run_device

    class Broken:
        def cpu(self):
            raise RuntimeError("injected readback failure")

    pipe.run_device = lambda frames: (Broken(),) + real(frames)[1:]
    try:
        with pytest.raises(ServerError, match="readback"):
            server.batcher.submit(frame, timeout=10)
    finally:
        del pipe.run_device
    assert server.batcher.submit(frame, timeout=30).mask.shape == (64, 64)


def test_bad_shape_frame_rejected_thread_survives(server, rng):
    for shape in ((64, 64), (3, 64, 64)):
        with pytest.raises(ValueError, match="expected frame shape"):
            server.batcher.submit(rng.integers(0, 256, shape,
                                               dtype=np.uint8))
    assert not server.batcher._dispatch_dead.is_set()
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    assert server.batcher.submit(frame).mask.shape == (64, 64)


def test_abandoned_requests_skip_dispatch(server, rng):
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    ghost = _Request(frame=frame)
    ghost.abandoned = True
    d0 = server.batcher.stats["dispatches"]
    server.batcher.q.put(ghost)
    assert server.batcher.submit(frame, timeout=30).mask.shape == (64, 64)
    assert server.batcher.stats["dispatches"] - d0 >= 1
    assert not ghost.done.is_set()


def test_variants_match_offline_pipeline(server, rng):
    """raw is the offline pipeline's mask as a PNG; crf is the CRF
    callable applied to that raw mask (a stand-in callable here; the
    card's smoke run uses DenseCRF); -crf missing gives 400."""
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    want = server.pipe.run(np.tile(frame[None], (8, 1, 1, 1))).masks[0, ..., 0]
    raw = _levels(server.segment_bytes(_png(frame)))
    np.testing.assert_array_equal(
        raw, (np.clip(want, 0, 1) * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="without --crf"):
        server.segment_bytes(_png(frame), variant="crf")
    seen = []

    def crf(imgs, masks):
        seen.append((imgs.copy(), masks.copy()))
        return masks > np.median(masks)

    server.crf_fn = crf
    try:
        png = server.segment_bytes(_png(frame), variant="crf")
    finally:
        server.crf_fn = None
    np.testing.assert_array_equal(seen[0][0][0], frame)
    np.testing.assert_allclose(seen[0][1][0], want, atol=1e-6)
    np.testing.assert_array_equal(_levels(png),
                                  (want > np.median(want)) * 255)


def test_separate_run_serves_sepcrit_features(tmp_path, rng):
    cfg = parse_args(ARGS + ["--serve-wait-ms", "5", "-separate",
                             "--model", str(tmp_path / "norun")])
    assert cfg.separate
    srv = MaskServer(cfg)
    try:
        pipe = srv.batcher.pipeline
        assert pipe.separate and "sepcrit" in pipe.params
        frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        served = srv.batcher.submit(frame).mask
        out = pipe.run(np.tile(frame[None], (8, 1, 1, 1)))
        np.testing.assert_allclose(served, out.masks[0, :, :, 0], atol=1e-6)
        # and not the critic's features
        solo = MaskPipeline(pipe.critic, pipe.masker,
                            {k: pipe.params[k] for k in ("critic", "masker")},
                            batch_size=8, device="cpu")
        alt = solo.run(np.tile(frame[None], (8, 1, 1, 1))).masks[0, :, :, 0]
        assert np.abs(alt - served).max() > 1e-4
    finally:
        srv.batcher.close()


def test_serve_uses_handler_checkpoint_paths(tmp_path, capsys):
    """_load_params looks where Handler saves and reports the random
    init; the init is Handler.reset_models' (seeded critic, masker)."""
    cfg = parse_args(ARGS + ["--model", str(tmp_path / "norun")])
    srv = MaskServer(cfg)
    srv.batcher.close()
    out = capsys.readouterr().out
    for name in ("critic", "masker"):
        assert checkpoint_paths(cfg)[name] in out
        assert f"serving a RANDOM {name}" in out
    gen = torch.Generator().manual_seed(cfg.seed)
    for name, template in (("critic", Critic()), ("masker", UnetDecoder())):
        want = init_torch_default(template, gen).state_dict()
        for k, v in want.items():
            assert torch.equal(srv.pipe.params[name][k], v)


def test_data_parallel_and_no_card_raise(tmp_path, rng, capsys,
                                        monkeypatch):
    """--data-parallel 2 serves over two ranks (MaskServer starts the
    second; /stats names the world). An --ensemble that does not divide
    over the ranks is served as the JAX server serves it
    (cgs_tpu/serve.py:264-275): one warning, then rank 0 serves the
    whole ensemble unmeshed, its masks equal to the one-rank --ensemble
    3 server's; MaskServer starts no second rank, and in a world already
    joined (as under torchrun) the other rank's `serve.main` returns at
    once. Without a card the default device raises."""
    from cgs_tpu_torch.parallel import mesh as mesh_mod, multihost, probes

    run = ["--model", str(tmp_path / "norun")]
    srv = MaskServer(parse_args(ARGS + run + ["--data-parallel", "2"]))
    try:
        assert srv.world == 2 and srv.mesh is not None
        frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        assert srv.batcher.submit(frame).mask.shape == (64, 64)
    finally:
        srv.shutdown()

    ens = str(tmp_path / "ens")
    for s in range(3):
        cfg = parse_args(ARGS + ["--model", f"{ens}-seed{s}"])
        paths = checkpoint_paths(cfg)
        os.makedirs(os.path.dirname(paths["critic"]), exist_ok=True)
        params = port_params(jax_models(seed=20 + s)[2])
        for name in ("critic", "masker"):
            save_model_pt(params[name], name, paths[name])
    argv = ARGS + ["--model", ens, "--ensemble", "3"]
    frames = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    monkeypatch.setattr(mesh_mod, "_ensemble_warned", set())
    capsys.readouterr()
    one = MaskServer(parse_args(argv))
    uneven = MaskServer(parse_args(argv + ["--data-parallel", "2"]))
    try:
        assert uneven.world == 1 and uneven.mesh is None
        assert uneven._ranks is None and len(uneven.pipe._members) == 3
        want = np.stack([one.batcher.submit(f).mask for f in frames])
        got = np.stack([uneven.batcher.submit(f).mask for f in frames])
        np.testing.assert_array_equal(got, want)
    finally:
        one.batcher.close()
        uneven.shutdown()
    assert capsys.readouterr().out.count("--ensemble 3 does not divide "
                                         "over 2 ranks") == 1
    joined = multihost.launch(
        probes.serve_joined, 2, (argv + ["--data-parallel", "2"], frames),
        device="cpu", timeout_s=60.0, join_s=60.0)
    assert joined["world"] == 1 and not joined["meshed"]
    np.testing.assert_array_equal(joined["masks"], want)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MaskServer(parse_args(["--infer-batch", "8"] + run))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--infer-batch", "8", "--port", "0"] + run)


def test_http_burst_no_connection_resets(http, rng):
    body = _png(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))

    def one(_):
        req = urllib.request.Request(f"{http}/segment", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status

    with cf.ThreadPoolExecutor(max_workers=40) as ex:
        assert list(ex.map(one, range(40))) == [200] * 40


def _perturbed(state, delta):
    return {k: v + delta for k, v in state.items()}


def test_reload_checkpoints_hot_swaps_weights(tmp_path, rng):
    cfg = parse_args(ARGS + ["--serve-wait-ms", "5",
                             "--model", str(tmp_path / "run")])
    os.makedirs(os.path.dirname(checkpoint_paths(cfg)["critic"]),
                exist_ok=True)
    srv = MaskServer(cfg)
    try:
        assert srv.reload_checkpoints() == {"critic": False,
                                            "masker": False}
        assert srv.reloads == 0
        frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        before = srv.batcher.submit(frame).mask
        host = srv.pipe.params
        save_model_pt(_perturbed(host["masker"], 0.2), "masker",
                      checkpoint_paths(cfg)["masker"])
        assert srv.reload_checkpoints() == {"critic": False, "masker": True}
        assert srv.reloads == 1
        after = srv.batcher.submit(frame).mask
        assert np.abs(after - before).max() > 1e-4
        for k, v in host["critic"].items():    # kept, not re-randomised
            assert torch.equal(srv.pipe.params["critic"][k], v)
        # a corrupt file keeps that model's served weights
        with open(checkpoint_paths(cfg)["critic"], "wb") as fp:
            fp.write(b"not a checkpoint")
        assert srv.reload_checkpoints() == {"critic": False, "masker": True}
    finally:
        srv.batcher.close()


def test_reload_http_endpoint(server, http):
    req = urllib.request.Request(f"{http}/reload", data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200
        payload = json.loads(r.read())
    assert payload["reloaded"] == {"critic": False, "masker": False}
    with urllib.request.urlopen(f"{http}/stats", timeout=30) as r:
        assert "reloads" in json.loads(r.read())


def test_stats_queue_wait_grows_with_requests(server, http, rng):
    """/stats' queue_wait_s: the summed submit-to-dispatch seconds of
    the dispatched requests, there from the start and growing with each
    request."""
    def stats():
        with urllib.request.urlopen(f"{http}/stats", timeout=30) as r:
            return json.loads(r.read())

    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    before = stats()
    assert before["queue_wait_s"] >= 0.0
    waits = [before["queue_wait_s"]]
    for _ in range(3):
        server.segment_bytes(_png(frame))
        waits.append(stats()["queue_wait_s"])
    assert all(b > a for a, b in zip(waits, waits[1:])), waits
    assert stats()["dispatches"] - before["dispatches"] == 3


def test_reload_under_concurrent_traffic(tmp_path, rng):
    """Clients post while two weight sets (critic and masker both
    changed) are swapped in turn: every response equals set A's or set
    B's mask of its frame, never a mix, and each response after a
    reload returns is the new set's."""
    cfg = parse_args(ARGS + ["--serve-wait-ms", "5",
                             "--model", str(tmp_path / "run")])
    paths = checkpoint_paths(cfg)
    os.makedirs(os.path.dirname(paths["masker"]), exist_ok=True)
    srv = MaskServer(cfg)
    try:
        a = srv.pipe.params
        b = {n: _perturbed(s, 0.05) for n, s in a.items()}
        frames = rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8)
        expect = []
        for params in (a, b):
            pipe = MaskPipeline(srv.pipe.critic, srv.pipe.masker, params,
                                batch_size=8, device="cpu")
            expect.append((np.clip(pipe.run(frames).masks[..., 0], 0, 1)
                           * 255).astype(np.int16))
        assert np.abs(expect[0] - expect[1]).max() > 10
        seen, errors = [], []
        done = threading.Event()

        def client(i):
            try:
                for k in range(6):
                    f = (i + k) % 16
                    seen.append((f, _levels(srv.segment_bytes(
                        _png(frames[f])))))
            except Exception as e:
                errors.append(repr(e))

        def publish(params):
            for name, state in params.items():
                save_model_pt(state, name, paths[name])
            srv.reload_checkpoints()

        def reloader():
            j = 0
            while not done.is_set():
                j += 1
                publish(b if j % 2 else a)

        rt = threading.Thread(target=reloader)
        rt.start()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        done.set()
        rt.join(timeout=120)
        assert not any(t.is_alive() for t in threads + [rt])
        assert not errors, errors
        assert srv.reloads >= 2
        for f, got in seen:
            assert min(np.abs(got - e[f]).max() for e in expect) <= 1, \
                f"frame {f}: a response of neither weight set"
        for which, params in ((1, b), (0, a)):
            publish(params)
            got = _levels(srv.segment_bytes(_png(frames[3])))
            assert np.abs(got - expect[which][3]).max() <= 1
    finally:
        srv.batcher.close()


# -- the u8 serve wire -------------------------------------------------

@pytest.fixture(scope="module")
def u8_server(tmp_path_factory):
    cfg = parse_args(ARGS + ["--serve-wait-ms", "30", "--serve-wire", "u8",
                             "--binarymaskthreshold", "0.5", "--model",
                             str(tmp_path_factory.mktemp("srv8") / "norun")])
    srv = MaskServer(cfg)
    yield srv
    srv.batcher.close()


def test_u8_wire_raw_png_bit_identical(server, u8_server, rng):
    body = _png(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    assert u8_server.segment_bytes(body) == server.segment_bytes(body)


def test_u8_wire_thresholded_exact_at_server_threshold(server, u8_server,
                                                       rng):
    body = _png(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    assert (server.segment_bytes(body, variant="thresholded", threshold=0.5)
            == u8_server.segment_bytes(body, variant="thresholded",
                                       threshold=0.5))


def test_u8_wire_rejects_custom_threshold_and_crf(u8_server, rng):
    body = _png(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    with pytest.raises(ValueError, match="f32 wire"):
        u8_server.segment_bytes(body, variant="thresholded", threshold=0.25)
    with pytest.raises(ValueError, match="f32"):
        u8_server.segment_bytes(body, variant="crf")


def test_u8_wire_incompatible_with_crf_at_start(tmp_path):
    cfg = parse_args(ARGS + ["--serve-wire", "u8", "-crf",
                             "--model", str(tmp_path / "norun")])
    with pytest.raises(ValueError, match="crf"):
        MaskServer(cfg)


# -- the port against the JAX package ----------------------------------

@pytest.fixture(scope="module")
def both_servers(tmp_path_factory):
    """A JAX and a port MaskServer on one run dir of .pt files that the
    port's save_model_pt wrote from JAX params (seed 3)."""
    run = str(tmp_path_factory.mktemp("parity") / "run")
    common = ["--infer-batch", "8", "--serve-wait-ms", "5", "--model", run]
    pcfg, jcfg = parse_args(common + ["--device", "cpu"]), jax_parse_args(
        common)
    paths = checkpoint_paths(pcfg)
    assert {k: paths[k] for k in ("critic", "masker")} == {
        k: jax_ckpt_paths(jcfg)[k] for k in ("critic", "masker")}
    _, _, jp = jax_models(seed=3)
    for name, state in port_params(jp).items():
        if name != "sepcrit":
            save_model_pt(state, name, paths[name])
    jsrv, psrv = JaxServer(jcfg), MaskServer(pcfg)
    yield jsrv, psrv
    jsrv.batcher.close()
    psrv.batcher.close()


def test_port_server_answers_as_jax_server(both_servers):
    jsrv, psrv = both_servers
    frames = np.random.default_rng(4).integers(0, 256, (6, 64, 64, 3),
                                               dtype=np.uint8)
    same = total = 0
    for frame in frames:
        body = _png(frame)
        j, p = _levels(jsrv.segment_bytes(body)), _levels(
            psrv.segment_bytes(body))
        assert np.abs(j - p).max() <= 1
        same += int((j == p).sum())
        total += j.size
        soft = jsrv.batcher.submit(frame).mask
        jt = _levels(jsrv.segment_bytes(body, variant="thresholded",
                                        threshold=0.5))
        pt = _levels(psrv.segment_bytes(body, variant="thresholded",
                                        threshold=0.5))
        far = np.abs(soft - 0.5) > 1e-5
        np.testing.assert_array_equal(jt[far], pt[far])
    assert same / total >= 0.999
