"""HTTP mask server (PyTorch port of `cgs_tpu/serve.py`; the reference's
only batch-inference surface is the offline `-process` folder walk,
main.py:1103-1223).

One `MaskPipeline` at one batch shape, fed by a micro-batcher that
coalesces concurrent requests for up to `--serve-wait-ms` and pads them
into one dispatch: per dispatch, one H2D copy of 12 KB a frame, one
ingest kernel, the critic, the decoder with its five fused join
kernels, and one readback.

Run:  python -m cgs_tpu_torch.serve --model RUN --port 8700 [--device cpu]
API:  POST /segment        body = PNG/JPEG (64x64 RGB; ?resize=1 to
                           auto-resize other sizes)
                           ?variant=raw|thresholded|crf
                           ?threshold=0.5   (thresholded only, `>=` as
                           -process; crf refines the raw soft mask)
      -> image/png grayscale mask (input resolution);
         400 = client error, 503 = inference failure/overload
      POST /reload         -> hot-swap the run dir's current .pt
                           checkpoints into the live pipeline (missing
                           files keep the served weights);
                           JSON {reloaded: {name: bool}, reloads}
      GET  /healthz        -> JSON {status, dispatches, frames,
                           errors, queue_wait_s, batch, reloads}
      GET  /stats          -> same JSON, plus world; queue_wait_s is
                           the sum over dispatched requests of the
                           seconds from submit to dispatch

The flags are the training CLI's (core/config.py): --model picks the
run directory whose fingerprinted .pt checkpoints are served,
--infer-batch the micro-batch (default 256), --bf16 / -crf / --ensemble
N as in -process. --serve-wire u8 brings the mask down as PNG-space
uint8 (a quarter of the bytes; `raw` stays bit-identical) and, with
--binarymaskthreshold, the in-graph hard plane for `thresholded` at the
server's threshold; per-request thresholds and -crf need the f32 mask
and are refused there (400). The server runs on the card unless
--device cpu.

Over several cards (port of `cgs_tpu/serve.py:262-309`, where one JAX
process shards each dispatch over a local mesh): one process per card,
--data-parallel N ranks (0, the default, and 1 serve on one rank;
under torchrun, torchrun's world). Rank 0 is the server: the HTTP
front, `MaskServer` and the `MicroBatcher`. Each dispatch is a
collective that the dispatch thread leads: a two-integer header
(segment / reload / stop) over the host group, then the padded uint8
batch with `Mesh.broadcast_`; every rank runs its rows through
`MaskPipeline(mesh=...)` and rank 0 reads the assembled outputs back. Ranks 1..N-1 run `serve_worker`, a loop
that waits for the next header. `MaskServer` starts them itself
(`parallel/multihost.py:start`) unless this process already is rank 0
of a world (torchrun; `main` sends the other ranks to `serve_worker`).
`--ensemble R` shards the members over the ranks; where R % N != 0 it
warns once and rank 0 serves the whole ensemble unmeshed, as the JAX
server does (`parallel/mesh.py:ensemble_divides`): `MaskServer` then
starts no other rank, and in a world already joined the other ranks
leave `serve_worker` at once. A `/reload`
loads on rank 0 and is itself a dispatch: the new weight set is
broadcast and every rank swaps it in with one assignment between the
same two batches, so no response mixes two sets. A collective that
fails (a dead rank) fails its requests and ends the serving; later
requests fail at once (503), and `/healthz` reports it. `/stats` also
reports the world size.

Threads on the card: the dispatch thread launches each batch on the
device's default stream and the completion thread's `.cpu()` readback
queues on that same stream, so it orders after the batch's compute
with no event; a device error that surfaces at the readback fails that
batch's requests, not the thread.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from cgs_tpu_torch.core.config import Config, parse_args
from cgs_tpu_torch.parallel import multihost
from cgs_tpu_torch.parallel.mesh import current_mesh, ensemble_divides

VARIANTS = ("raw", "thresholded", "crf")
MAX_INFLIGHT = 2    # dispatched batches whose outputs wait on the device
# a dispatch's header over the ranks: (operation, frames); an idle
# header every HEARTBEAT_S without traffic keeps the workers' waits
# inside the collective timeout, and finds a dead rank while idle
OP_SEGMENT, OP_RELOAD, OP_STOP, OP_IDLE = 1, 2, 3, 4
HEARTBEAT_S = 1.0


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer with an accept backlog of 128 (its default of
    5 resets a burst of concurrent clients, the batcher's whole point)."""
    request_queue_size = 128
    daemon_threads = True


@dataclass
class _Request:
    frame: np.ndarray                  # (64, 64, 3) uint8
    done: threading.Event = field(default_factory=threading.Event)
    mask: Optional[np.ndarray] = None  # (64, 64) f32 soft mask, or
    #                                    uint8 0..255 under --serve-wire u8
    hard: Optional[np.ndarray] = None  # (64, 64) uint8 0/1 in-graph
    #                                    binarisation (u8 wire with
    #                                    --binarymaskthreshold only)
    pred: float = 0.0
    error: Optional[str] = None        # batch-level failure message
    abandoned: bool = False            # submitter gave up (timeout)
    t_submit: float = field(default_factory=time.perf_counter)


class ServerError(RuntimeError):
    """Inference-side failure (device error, overload timeout): HTTP
    503, unlike a client's ValueError (400)."""


class MicroBatcher:
    """Coalesce concurrent requests into fixed-shape dispatches.

    The dispatch thread drains the queue (at most `max_wait_ms` after
    the first request, up to `batch` frames), pads to the batch,
    uploads and launches one forward; the completion thread reads the
    outputs back and completes the requests. Launches are asynchronous,
    so batch N+1 forms and launches while batch N is read back; at most
    `MAX_INFLIGHT` batches' outputs wait on the device.

    Over a mesh (this is rank 0) the dispatch thread leads each dispatch
    and each `control` operation (a reload) as a collective that every
    rank's `serve_worker` joins, in one order; a failed collective ends
    the serving (`broken`).
    """

    def __init__(self, pipeline, batch: int, max_wait_ms: float = 2.0,
                 mesh=None):
        self.pipeline = pipeline
        self.mesh = mesh
        self.broken: Optional[str] = None   # why the ranks stopped serving
        self._ctl: "queue.Queue" = queue.Queue()
        self._has_hard = getattr(pipeline, "hard_threshold",
                                 None) is not None
        self.batch = int(batch)
        self.max_wait = max_wait_ms / 1000.0
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=MAX_INFLIGHT)
        self.stats = {"dispatches": 0, "frames": 0, "errors": 0,
                      "queue_wait_s": 0.0}
        self._stop = threading.Event()
        self._dispatch_dead = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._thread.start()
        self._completer.start()

    def submit(self, frame: np.ndarray, timeout: float = 30.0) -> _Request:
        if self._dispatch_dead.is_set():
            raise ServerError(f"not serving: {self.broken or 'stopped'}")
        frame = np.asarray(frame)
        if frame.shape != (64, 64, 3):
            raise ValueError(
                f"expected frame shape (64, 64, 3), got {frame.shape}")
        req = _Request(frame=frame.astype(np.uint8, copy=False))
        self.q.put(req)
        if not req.done.wait(timeout):
            # the dispatch thread skips it instead of spending a batch
            # slot on a frame nobody will read
            req.abandoned = True
            raise ServerError("inference timed out")
        if req.error is not None:
            raise ServerError(req.error)
        return req

    def control(self, payload, timeout: float = 120.0) -> None:
        """Over a mesh: swap in the weight set `payload` on every rank,
        between two dispatches (the dispatch thread broadcasts it);
        returns once rank 0 has swapped."""
        if self._dispatch_dead.is_set():
            raise ServerError(f"not serving: {self.broken or 'stopped'}")
        box = {"done": threading.Event(), "error": None}
        self._ctl.put((payload, box))
        if not box["done"].wait(timeout):
            raise ServerError("reload timed out")
        if box["error"] is not None:
            raise ServerError(box["error"])

    def _controls(self) -> None:
        while True:
            try:
                payload, box = self._ctl.get_nowait()
            except queue.Empty:
                return
            try:
                self.mesh.broadcast_ints((OP_RELOAD, 0))
                self.mesh.broadcast_object(payload)
                self.pipeline.update_params(payload)
            except Exception as e:
                box["error"] = f"{type(e).__name__}: {e}"
                raise
            finally:
                box["done"].set()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        # the dispatch thread sets _dispatch_dead when it exits, after
        # its last _inflight.put; the completer drains and stops then
        self._completer.join(timeout=5)
        while True:
            try:
                req = self.q.get_nowait()
            except queue.Empty:
                break
            req.error = "server shutting down"
            req.done.set()

    def _drain(self) -> list:
        """One request, then more until the batch is full or max_wait
        has passed since the first; abandoned requests are dropped."""
        try:
            first = self.q.get(timeout=0.1)
        except queue.Empty:
            return []
        reqs = [] if first.abandoned else [first]
        deadline = time.monotonic() + self.max_wait
        while len(reqs) < self.batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                req = self.q.get(timeout=left)
            except queue.Empty:
                break
            if not req.abandoned:
                reqs.append(req)
        return reqs

    @staticmethod
    def _fail(reqs, exc, stats) -> None:
        stats["errors"] += 1
        msg = f"{type(exc).__name__}: {exc}"
        print(f"[cgs-tpu-torch serve] batch failed: {msg}")
        for r in reqs:
            r.error = msg
            r.done.set()

    def _loop(self) -> None:
        try:
            self._loop_body()
        except Exception as e:          # a collective failed (a dead rank)
            self.broken = f"{type(e).__name__}: {e}"
            print(f"[cgs-tpu-torch serve] the ranks stopped serving: "
                  f"{self.broken}")
        finally:
            if self.mesh is not None and self.broken is None:
                try:                    # the workers' loops end
                    self.mesh.broadcast_ints((OP_STOP, 0))
                except Exception:
                    pass
            self._dispatch_dead.set()
            if self.broken is not None:
                self._fail_queued(self.broken)

    def _fail_queued(self, msg: str) -> None:
        for q in (self.q, self._ctl):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if q is self._ctl:
                    item[1]["error"] = msg
                    item[1]["done"].set()
                else:
                    item.error = msg
                    item.done.set()

    def _loop_body(self) -> None:
        beat = time.monotonic()
        while not self._stop.is_set():
            if self.mesh is not None:
                self._controls()
            reqs = self._drain()
            if not reqs:
                if (self.mesh is not None
                        and time.monotonic() - beat > HEARTBEAT_S):
                    self.mesh.broadcast_ints((OP_IDLE, 0))
                    beat = time.monotonic()
                continue
            beat = time.monotonic()
            t = time.perf_counter()
            try:
                # a fresh host batch per dispatch: the upload has read
                # it when place_input returns
                frames = np.zeros((self.batch, 64, 64, 3), np.uint8)
                for i, r in enumerate(reqs):
                    frames[i] = r.frame
                x = self.pipeline.place_input(frames)
                if self.mesh is not None:   # every rank joins the dispatch
                    self.mesh.broadcast_ints((OP_SEGMENT, len(reqs)))
                    self.mesh.broadcast_(x)
                out = self.pipeline.run_device(x)
            except Exception as e:      # fail the batch, keep the thread
                self._fail(reqs, e, self.stats)
                if self.mesh is not None:
                    raise               # ... unless the world is broken
                continue
            self.stats["dispatches"] += 1
            self.stats["frames"] += len(reqs)
            self.stats["queue_wait_s"] += sum(t - r.t_submit for r in reqs)
            self._inflight.put((reqs, out))   # blocks at MAX_INFLIGHT

    def _complete_loop(self) -> None:
        while not (self._dispatch_dead.is_set()
                   and self._inflight.empty()):
            try:
                reqs, out = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                # the readback; a device error of the batch surfaces here
                pred, mask = out[0].cpu().numpy(), out[1].cpu().numpy()
                hard = out[3].cpu().numpy() if self._has_hard else None
            except Exception as e:
                self._fail(reqs, e, self.stats)
                continue
            for i, r in enumerate(reqs):
                r.mask = mask[i, :, :, 0]
                if hard is not None:
                    r.hard = hard[i, :, :, 0]
                r.pred = float(pred[i])
                r.done.set()


def _templates(cfg):
    """The critic and masker modules that fix the served architecture
    (`models/build.py:build_pair`)."""
    from cgs_tpu_torch.models.build import build_pair

    return build_pair(cfg, torch.bfloat16 if cfg.bf16 else torch.float32)


def _wire(cfg):
    """(wire, the in-graph hard threshold or None) of the server."""
    wire = cfg.serve_wire
    hard = (float(cfg.binarymaskthreshold)
            if wire == "u8" and cfg.binarymaskthreshold else None)
    if wire == "u8" and cfg.crf:
        raise ValueError(
            "--serve-wire u8 is incompatible with --crf: CRF "
            "refinement consumes f32 soft-mask probabilities")
    return wire, hard


def _make_pipeline(cfg, params, mesh):
    """The served pipeline on this rank's device, warmed with one batch
    (over a mesh a collective every rank makes): cuDNN settles its
    algorithms for the batch shape the batcher always dispatches."""
    from cgs_tpu_torch.pipeline import MaskPipeline

    critic, masker = _templates(cfg)
    ensemble = cfg.ensemble > 0
    wire, hard = _wire(cfg)
    # separate: a -separate run's masker reads the sepcrit's features
    # (main.py:946-947), as the offline -process does
    pipe = MaskPipeline(critic, masker, params,
                        batch_size=cfg.infer_batch or 256,
                        eval_mode=not cfg.noevalmode, seed=cfg.seed,
                        separate=cfg.separate and not ensemble,
                        ensemble=ensemble, wire=wire, hard_threshold=hard,
                        device=cfg.device if mesh is None else mesh.device,
                        mesh=mesh)
    warm = pipe.run_device(pipe.place_input(
        np.zeros((pipe.batch, 64, 64, 3), np.uint8)))
    warm[1].cpu()
    return pipe


def serve_worker(cfg: Config) -> None:
    """Rank 1..N-1 of a served world: take rank 0's weights, build the
    same pipeline, then join every dispatch rank 0's batcher leads (its
    rows of each batch; a reload's swap) until the stop header. A Ctrl-C
    at the terminal reaches the whole process group: a worker leaves it
    to rank 0, whose shutdown sends the stop header."""
    import signal

    mesh = current_mesh()
    if cfg.ensemble > 0 and not ensemble_divides(cfg.ensemble, mesh.world):
        return                  # rank 0 serves the ensemble unmeshed
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    pipe = _make_pipeline(cfg, mesh.broadcast_object(None), mesh)
    frames = torch.empty((pipe.batch, 64, 64, 3), dtype=torch.uint8,
                         device=mesh.device)
    while True:
        op, _ = mesh.broadcast_ints((0, 0))
        if op == OP_STOP:
            return
        if op == OP_RELOAD:
            pipe.update_params(mesh.broadcast_object(None))
        elif op == OP_SEGMENT:
            pipe.run_device(mesh.broadcast_(frames))


def _serve_world(cfg: Config, backend=None, device_indices=None,
                 timeout_s: float = multihost.TIMEOUT_S):
    """(this rank 0's Mesh or None, the Ranks this call started or None):
    the world this process already is rank 0 of, else --data-parallel
    ranks, where 0 (the default) and 1 serve on one rank. (Unlike the
    CLI's, the server's default is not every card: a second card does
    not lift a host-bound server.) An --ensemble that does not divide
    over the ranks is served unmeshed: None, and no rank started."""
    n = max(1, int(cfg.data_parallel))
    mesh = current_mesh()
    if mesh is not None:
        if cfg.data_parallel > 0 and cfg.data_parallel != mesh.world:
            raise ValueError(f"--data-parallel {cfg.data_parallel} but this "
                             f"process is a rank of a world of {mesh.world}")
        if mesh.rank != 0:
            raise ValueError("MaskServer runs on rank 0; the other ranks "
                             "run serve_worker")
        n = mesh.world
    if cfg.ensemble > 0 and n > 1 and not ensemble_divides(cfg.ensemble, n):
        return None, None
    if mesh is not None or n <= 1:
        return (mesh if mesh is not None and mesh.world > 1 else None), None
    if (torch.device(cfg.device).type == "cuda" and device_indices is None
            and n > torch.cuda.device_count()):
        raise ValueError(
            f"--data-parallel {n} needs {n} cards (NCCL takes one rank per "
            f"card); {torch.cuda.device_count()} are present")
    ranks = multihost.start(serve_worker, n, (cfg,), device=cfg.device,
                            backend=backend, device_indices=device_indices,
                            timeout_s=timeout_s)
    return current_mesh(), ranks


class MaskServer:
    """Checkpointed models + micro-batcher + HTTP front, on cfg.device
    (cuda unless `--device cpu`).

    Over N > 1 ranks (module docstring) this is rank 0: it starts ranks
    1..N-1 running `serve_worker` unless it already is rank 0 of a
    joined world. backend, device_indices and timeout_s (a collective's
    limit: a dead rank fails the requests within it) go to
    `parallel/multihost.py:start` (e.g. "gloo" and [0, 0]: two ranks on
    one card). A process holds one served world at a time."""

    def __init__(self, cfg: Config, crf_fn=None, backend=None,
                 device_indices=None,
                 timeout_s: float = multihost.TIMEOUT_S):
        self.cfg = cfg
        mesh, self._ranks = _serve_world(cfg, backend, device_indices,
                                         timeout_s)
        self.mesh = mesh
        self.world = 1 if mesh is None else mesh.world
        try:
            self.wire, self.hard_thr = _wire(cfg)
            if cfg.ensemble > 0:
                # --ensemble N: the mean mask of the runs {model}-seed{s};
                # every member must exist (a random one would corrupt it)
                from cgs_tpu_torch.train.checkpoints import (
                    load_seed_ensemble,
                )
                params = load_seed_ensemble(cfg, cfg.ensemble)
            else:
                params = self._load_params(cfg, *_templates(cfg))
            if mesh is not None:        # rank 0's weights on every rank
                params = mesh.broadcast_object(params)
            self.pipe = _make_pipeline(cfg, params, mesh)
        except BaseException:
            self._end_ranks(check=False)
            raise
        self.batcher = MicroBatcher(self.pipe, self.pipe.batch,
                                    max_wait_ms=cfg.serve_wait_ms, mesh=mesh)
        self.crf_fn = crf_fn
        self.httpd: Optional[ThreadingHTTPServer] = None
        self._reload_lock = threading.Lock()
        self.reloads = 0

    def _end_ranks(self, check: bool = True) -> None:
        """Leave the world this server started; its workers have the
        stop header (check: they must exit cleanly) or are failed."""
        if self._ranks is not None:
            ranks, self._ranks = self._ranks, None
            ranks.close(multihost.JOIN_S if check else 5.0, check=check)

    def _swap(self, params) -> None:
        """Serve `params` from the next dispatch on, on every rank."""
        if self.mesh is None:
            self.pipe.update_params(params)
        else:
            self.batcher.control(params)

    @staticmethod
    def _load_params(cfg, critic, masker):
        """The fingerprinted .pt checkpoints of the run dir (the
        `checkpoint_paths` Handler saves under); where one is missing, a
        random init, loudly reported, drawn as `Handler.reset_models`
        draws it (PyTorch's default init from a generator seeded with
        --seed: critic, masker, then sepcrit)."""
        from cgs_tpu_torch.models.interop import init_torch_default
        from cgs_tpu_torch.train.checkpoints import (
            checkpoint_paths, load_model_pt,
        )

        gen = torch.Generator().manual_seed(cfg.seed)
        names = ["critic", "masker"] + (["sepcrit"] if cfg.separate else [])
        params = {}
        for name in names:
            template = masker if name == "masker" else critic
            init_torch_default(template, gen)
            params[name] = {k: v.detach().clone()
                            for k, v in template.state_dict().items()}
        for name, path in checkpoint_paths(cfg).items():
            if name not in params:
                continue
            loaded = load_model_pt(name, path, cfg.critic_arch)
            if loaded is None:
                print(f"[cgs-tpu-torch serve] {path} not found — "
                      f"serving a RANDOM {name}")
            else:
                print(f"[cgs-tpu-torch serve] loaded {path}")
                params[name] = loaded
        return params

    def reload_checkpoints(self) -> dict:
        """Re-read the run dir's fingerprinted .pt checkpoints and swap
        them into the live pipeline (the continuous-training loop:
        Handler overwrites the same names every --saveevery epochs,
        main.py:228,565). A missing or unreadable file keeps the served
        weights of that model, never a random init; an ensemble reloads
        all members or none. The swap is `MaskPipeline.update_params`:
        a dispatch in flight finishes on the old weights, the next one
        reads the new (over ranks, on every rank between the same two
        dispatches). Returns {model name: loaded}."""
        from cgs_tpu_torch.train.checkpoints import (
            checkpoint_paths, load_model_pt, load_seed_ensemble,
        )

        if self.cfg.ensemble > 0:
            with self._reload_lock:
                try:
                    params = load_seed_ensemble(self.cfg, self.cfg.ensemble)
                except Exception as e:
                    # a member mid-overwrite can fail to unpickle: keep
                    # the served weights rather than answer 500
                    print(f"[cgs-tpu-torch serve] ensemble reload skipped: "
                          f"{type(e).__name__}: {e} — keeping served "
                          "weights")
                    return {"ensemble": False}
                self._swap(params)
                self.reloads += 1
                print(f"[cgs-tpu-torch serve] reloaded ensemble of "
                      f"{self.cfg.ensemble}")
                return {"ensemble": True}

        with self._reload_lock:
            params = dict(self.pipe.params)
            loaded = {}
            for name, path in checkpoint_paths(self.cfg).items():
                if name not in params:
                    continue
                try:
                    new = load_model_pt(name, path,
                                        self.cfg.critic_arch)
                except Exception as e:
                    # per-model isolation: one corrupt file keeps its
                    # model's served weights and spoils no other
                    print(f"[cgs-tpu-torch serve] reload {name}: "
                          f"{type(e).__name__}: {e} — keeping served "
                          "weights")
                    loaded[name] = False
                    continue
                loaded[name] = new is not None
                if new is not None:
                    params[name] = new
            if any(loaded.values()):
                self._swap(params)
                self.reloads += 1
                ok = sorted(n for n, got in loaded.items() if got)
                print(f"[cgs-tpu-torch serve] reloaded {ok}")
            return loaded

    # -- request handling -------------------------------------------

    def segment_bytes(self, body: bytes, variant: str = "raw",
                      threshold: float = 0.5,
                      resize: bool = False) -> bytes:
        """Image bytes -> PNG mask bytes (the HTTP-free core)."""
        from PIL import Image

        img = Image.open(io.BytesIO(body)).convert("RGB")
        w, h = img.size
        if (w, h) != (64, 64):
            if not resize:
                raise ValueError(
                    f"expected 64x64 input, got {w}x{h} "
                    "(pass ?resize=1 to auto-resize)")
            img = img.resize((64, 64), Image.BILINEAR)
        frame = np.asarray(img, np.uint8)
        req = self.batcher.submit(frame)
        mask = req.mask
        if self.wire == "u8":
            # the quantized wire: mask is already the PNG payload
            if variant == "crf":
                raise ValueError(
                    "crf variant needs f32 soft masks — restart the "
                    "server without --serve-wire u8")
            if variant == "thresholded":
                if req.hard is None:
                    raise ValueError(
                        "thresholded variant under --serve-wire u8 "
                        "needs --binarymaskthreshold set at server "
                        "start (the binarisation runs in-graph)")
                if abs(threshold - self.hard_thr) > 1e-12:
                    raise ValueError(
                        f"--serve-wire u8 binarises in-graph at the "
                        f"server threshold {self.hard_thr}; "
                        f"per-request ?threshold={threshold} is only "
                        "available on the f32 wire")
                png_mask = req.hard * np.uint8(255)
            else:
                png_mask = mask
            out = Image.fromarray(png_mask, "L")
        else:
            if variant == "crf":
                if self.crf_fn is None:
                    raise ValueError("server started without --crf")
                refined = self.crf_fn(frame[None], mask[None])
                mask = np.asarray(refined)[0].astype(np.float32)
            elif variant == "thresholded":
                # >= as the offline -process binarisation
                mask = (mask >= threshold).astype(np.float32)
            out = Image.fromarray(
                (np.clip(mask, 0, 1) * 255).astype(np.uint8), "L")
        if (w, h) != (64, 64):
            out = out.resize((w, h), Image.NEAREST)
        buf = io.BytesIO()
        out.save(buf, format="PNG")
        return buf.getvalue()

    # -- HTTP front --------------------------------------------------

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet access log
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path in ("/healthz", "/stats"):
                    dead = server.batcher._dispatch_dead.is_set()
                    extra = {"world": server.world} if path == "/stats" \
                        else {}
                    self._json(503 if dead else 200,
                               {"status": "dead" if dead else "ok",
                                **server.batcher.stats,
                                "batch": server.batcher.batch,
                                "reloads": server.reloads, **extra})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                url = urlparse(self.path)
                if url.path == "/reload":
                    try:
                        loaded = server.reload_checkpoints()
                    except Exception as e:
                        self._json(500, {"error": f"{type(e).__name__}"
                                                  f": {e}"})
                        return
                    self._json(200, {"reloaded": loaded,
                                     "reloads": server.reloads})
                    return
                if url.path != "/segment":
                    self._json(404, {"error": "not found"})
                    return
                qs = parse_qs(url.query)
                variant = qs.get("variant", ["raw"])[0]
                if variant not in VARIANTS:
                    self._json(400, {"error": f"variant must be one "
                                              f"of {VARIANTS}"})
                    return
                try:
                    threshold = float(
                        qs.get("threshold",
                               [str(server.cfg.binarymaskthreshold)])[0])
                    n = int(self.headers.get("Content-Length", 0))
                    png = server.segment_bytes(
                        self.rfile.read(n), variant=variant,
                        threshold=threshold,
                        resize=qs.get("resize", ["0"])[0] == "1")
                except ServerError as e:     # device failure / overload
                    self._json(503, {"error": str(e)})
                    return
                except (ValueError, OSError) as e:
                    # OSError: PIL's UnidentifiedImageError on a body
                    # that is no image
                    self._json(400, {"error": str(e)})
                    return
                except Exception as e:       # e.g. a CRF RuntimeError
                    self._json(500, {"error": f"{type(e).__name__}: "
                                              f"{e}"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 8700):
        self.httpd = _Server((host, port), self.make_handler())
        return self.httpd

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8700):
        httpd = self.start(host, port)
        print(f"[cgs-tpu-torch serve] listening on http://{host}:{port} "
              f"(batch {self.batcher.batch}, "
              f"wait {self.batcher.max_wait * 1000:.0f} ms, "
              f"{self.pipe.device}, {self.world} rank(s))")
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self):
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
        self.batcher.close()           # over ranks: the stop header
        self._end_ranks(check=self.batcher.broken is None)


def main(argv=None):
    """`python -m cgs_tpu_torch.serve --model RUN [--port 8700] [--host
    127.0.0.1] [--device cpu] [--data-parallel N] <cli flags>`. On the
    card f32 runs with TF32 off, as the CLI's -process does. Under
    torchrun rank 0 serves and the other ranks run `serve_worker`."""
    import argparse

    from cgs_tpu_torch.core.device import resolve_device, train_switches

    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--port", type=int, default=8700)
    extra.add_argument("--host", type=str, default="127.0.0.1")
    extra_ns, rest = extra.parse_known_args(argv)
    cfg = parse_args(rest)
    multihost.ensure_initialized(cfg.device)  # torchrun's ranks join
    mesh = current_mesh()
    if resolve_device(cfg.device).type == "cuda":
        print("[cgs-tpu-torch serve] switches:",
              train_switches(cfg.bf16, train=False))
    if mesh is not None and mesh.rank != 0:
        try:
            serve_worker(cfg)
        finally:
            multihost.shutdown()
        return
    crf_fn = None
    if cfg.crf:
        from cgs_tpu_torch.eval.crf import DenseCRF
        crf_fn = DenseCRF(rescale=cfg.crf_rescale)
    try:
        MaskServer(cfg, crf_fn=crf_fn).serve_forever(
            host=extra_ns.host, port=extra_ns.port)
    finally:
        if mesh is not None:
            multihost.shutdown()


if __name__ == "__main__":
    main()
