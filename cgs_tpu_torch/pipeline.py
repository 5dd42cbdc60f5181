"""Batched mask inference, the `-process`/`-eval` forward path (PyTorch
port of `cgs_tpu/pipeline.py`; reference main.py:1130-1151 / 935-956).

One forward per batch, of any pair of `models/build.py` (the paper's
`Critic`, `ResNetCritic` with its BatchNorm in the module's mode, or
`ConvNeXtCritic` or `SwinV2Critic` with its drop-path in it, with the
`UnetDecoder` on its pyramid): uint8 NHWC frames are ingested
by the `normalize_u8` kernel (straight into bf16 when critic and decoder
compute in bf16 and no saliency is asked for, so neither model casts
its input), viewed as NCHW channels_last with no copy, run
through the critic (with its feature pyramid and, optionally, the
input-gradient saliency from the same pass) and the decoder, whose 5
skip joins are the fused upsample-into-concat kernel (`upsample2x`);
the outputs are encoded for the
wire on the device. Inputs and outputs keep the JAX package's layout:
frames (N, H, W, 3) uint8, masks (N, H, W, 1).

`run` chunks host frames into fixed batches, zero-pads the last one,
and streams them through a staging ring the pipeline owns: one slot per
batch in flight (`max_in_flight` of them), each a host buffer of frames
and one of each output (pinned on the card), the frames' device buffer,
and the events that order their copies. Per batch the host copies the
chunk into a free slot (torch's `copy_`, on the intra-op threads), the
upload stream copies it to the device, the compute stream waits for it
and runs the forward, and the read-back stream waits for the forward and
copies every row of each output into the slot's host buffers. Before a
slot is reused, and after the last batch, the host waits for those
copies and writes the batch's valid rows into the call's output arrays,
made once per call at N rows: while it does, the card runs the next
batches. The ring is made at the first call and grows only (a smaller
batch uses a prefix of each buffer). Off the card the same bookkeeping
runs with unpinned buffers and no side streams. `run` is not reentrant:
one call at a time per pipeline. `run_device` is the device-resident
path.

Under a profiler `run` names its host work (`utils/profiling.py:span`,
which also keeps each span's total duration and count while a profiler
records): `cgs.pipeline.run` around the call, and inside it `lead` (in
the first batch alone: taking its slot, any padding and its upload;
the card holds none of the call's work before it ends), `pad` (zeroing
the ragged last batch's tail in its slot), `upload` (the copy into the
slot and the enqueue of the upload), `forward` (`run_device`: the
enqueue of ingest, critic, decoder and wire encoding, then of the
read-back's copies) and `read_back` (the wait on a slot's copies and
the writes of its rows into the outputs; for the last batch those
writes are `tail`, after which the card holds none of the call's work).
`wait` is each host block on the card: on a slot's last upload before
it is refilled, and on its read-back before it is unstaged; off the card
there is no event and no wait. `run` alone adds to the counters
`pipeline.rows` (padding included), `pipeline.h2d_bytes`,
`pipeline.d2h_bytes` (every row of every output, padding included) and
`pipeline.staged_batches` (batches whose copies ran on the side streams
from pinned buffers: every batch on the card, none on the CPU), so a
caller of `place_input` and `run_device` (the server) moves none of
them. Each member's critic and decoder forward, on every path but int8,
is `models/build.py:critic_forward` / `masker_forward`: the spans
`cgs.model.critic` and `cgs.model.masker` and the `model.*` counters.

With `ensemble=True` (port of `cgs_tpu/pipeline.py:81-86,213-254`) the
pipeline holds R members and outputs the mean over them of pred, soft
mask and saliency: the batch is ingested once, each member's critic and
decoder run in turn (1 + 17R kernel launches per batch: each member's 5
joins and 12 convolution epilogues, `models/epilogue.py`; with salience
the critic records its input gradient and keeps PyTorch's epilogues, so
1 + 12R), the outputs are summed in f32 in member order and divided by
R, and only then encoded for the wire, so the u8 wire and the hard
plane see the mean mask.

With `quantize="int8"` (port of `cgs_tpu/pipeline.py:161-172,300-315,
377-395`) each member's convolutions run s8 x s8 -> s32
(`ops/quant.py`), the weights quantized once per `update_params`, the
activation scales dynamic, or static from a calibration batch (`calib`,
one f32 forward per `update_params`); the ingest and the decoder's
five joins launch the same kernels as in f32. The quantized forwards
are the paper's `Critic`'s: another critic is refused.

With `mesh` (a `parallel.mesh.Mesh`; port of `cgs_tpu/pipeline.py:63-73,
145-209,396-435,466-468`) the batch is padded to a multiple of the world
size, each rank runs its rows, and every rank gets the whole output
back, as JAX's multi-process `out_shardings=replicated` does: each
rank's rows are written into a zero-filled whole buffer and summed over
the ranks (`Mesh.assemble`; gloo has no all_gather for CUDA tensors).
With `ensemble=True` the mesh shards the seeds instead (R % N == 0):
each rank runs its R/N members on the whole batch, and the f32 sum of
the members goes through one `all_reduce` before the division by R and
the wire encoding.

`update_params` builds the new members' device weights off to the side
and swaps them in with one assignment, and `_forward` reads the member
list once per batch: a dispatch thread running meanwhile (`serve.py`)
sees the old weights or the new ones, never a mix, and work already on
the stream finishes on the old tensors.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from cgs_tpu_torch.core.device import resolve_device
from cgs_tpu_torch.models.build import critic_forward, masker_forward
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.ops.kernels import normalize_u8
from cgs_tpu_torch.ops.quant import (
    calibrate_act_scales, critic_apply_q, masker_apply_q, merge_act_scales,
    quantize_tree,
)
from cgs_tpu_torch.ops.saliency import critic_with_saliency
from cgs_tpu_torch.parallel.mesh import (
    pad_to_multiple, rank_seed, seed_shard_tree,
)
from cgs_tpu_torch.utils.profiling import counts, span


@dataclasses.dataclass
class PipelineOutput:
    preds: np.ndarray          # (N,) critic scores
    masks: Optional[np.ndarray]  # (N, H, W, 1) f32 soft masks
    #                              (None when wire='u8')
    saliency: Optional[np.ndarray] = None   # (N, H, W, 1) |input-grad|
    masks_u8: Optional[np.ndarray] = None   # (N, H, W, 1) uint8 0..255,
    #                              floor(255*clip(m,0,1)) (wire='u8')
    hard: Optional[np.ndarray] = None       # (N, H, W, 1) uint8 0/1,
    #                              (mask >= hard_threshold)


class _Slot:
    """One batch's place in the staging ring: its frames in host and
    device memory (one buffer off the card), a host buffer for each
    output, and the events that order their copies."""

    def __init__(self, rows: int, frame: tuple, dtype, device):
        cuda = device.type == "cuda"
        self.frames = torch.empty((rows, *frame), dtype=dtype,
                                  pin_memory=cuda)
        self.frames_dev = (torch.empty_like(self.frames, device=device)
                           if cuda else self.frames)
        self.outs: List[Optional[torch.Tensor]] = []
        self.uploaded, self.computed, self.copied = (
            (torch.cuda.Event() for _ in range(3)) if cuda
            else (None, None, None))


class _StagingRing:
    """`run`'s staging ring (module docstring): `slots` slots of `rows`
    frames each, and on the card the upload and read-back streams."""

    def __init__(self, slots: int, rows: int, frame: tuple,
                 dtype: np.dtype, device):
        cuda = device.type == "cuda"
        self.rows, self.frame, self.dtype = rows, frame, dtype
        self.device = device
        self.upload = torch.cuda.Stream(device) if cuda else None
        self.read_back = torch.cuda.Stream(device) if cuda else None
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        self.slots = [_Slot(rows, frame, tdtype, device)
                      for _ in range(slots)]
        self._outs_like: Optional[list] = None

    def holds(self, rows: int, frame: tuple, dtype: np.dtype) -> bool:
        return rows <= self.rows and (frame, dtype) == (self.frame,
                                                        self.dtype)

    def take(self, i: int) -> _Slot:
        """Batch i's slot, once its last upload is done: its host frames
        may be refilled."""
        slot = self.slots[i % len(self.slots)]
        if slot.uploaded is not None:
            with span("cgs.pipeline.wait"):
                slot.uploaded.synchronize()
        return slot

    def stage(self, slot: _Slot, chunk: np.ndarray, bs: int) -> None:
        """Copy the host chunk into the slot's first rows and enqueue the
        upload of its `bs` rows (a ragged tail was zeroed before)."""
        slot.frames[:chunk.shape[0]].copy_(
            torch.from_numpy(np.ascontiguousarray(chunk)))
        if self.upload is None:
            return
        with torch.cuda.stream(self.upload):
            # the device frames are free once their last forward ran
            self.upload.wait_event(slot.computed)
            slot.frames_dev[:bs].copy_(slot.frames[:bs], non_blocking=True)
            slot.uploaded.record(self.upload)

    def dispatch(self, slot: _Slot, bs: int, forward) -> tuple:
        """forward(the slot's device frames) on the compute stream, then
        the read-back of every output row into the slot's host buffers;
        returns the device outputs, which the caller holds until
        `unstage` has waited for their copies."""
        if self.upload is None:
            outs = forward(slot.frames_dev[:bs])
            self._copy_out(slot, outs, bs)
            return outs
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(slot.uploaded)
        outs = forward(slot.frames_dev[:bs])
        slot.computed.record(compute)
        with torch.cuda.stream(self.read_back):
            self.read_back.wait_event(slot.computed)
            self._copy_out(slot, outs, bs)
            slot.copied.record(self.read_back)
        return outs

    def _copy_out(self, slot: _Slot, outs: tuple, bs: int) -> None:
        self._host_buffers(outs)
        for host, t in zip(slot.outs, outs):
            if t is not None:
                host[:bs].copy_(t, non_blocking=True)

    def _host_buffers(self, outs: tuple) -> None:
        """Every slot's host buffers for outputs shaped like `outs`, made
        at the ring's first batch (so that the warm-up makes them)."""
        like = [None if t is None else (tuple(t.shape[1:]), t.dtype)
                for t in outs]
        if like == self._outs_like:
            return
        pin = self.upload is not None
        for slot in self.slots:
            slot.outs = [None if k is None else torch.empty(
                (self.rows, *k[0]), dtype=k[1], pin_memory=pin)
                for k in like]
        self._outs_like = like

    @staticmethod
    def unstage(slot: _Slot, dst: list, lo: int, hi: int) -> None:
        """Wait for the slot's read-back, then write its first hi - lo
        rows into rows lo:hi of the call's outputs (host tensors; the
        first is the scores); the writes of the call's last rows are
        `cgs.pipeline.tail`."""
        if slot.copied is not None:
            with span("cgs.pipeline.wait"):
                slot.copied.synchronize()
        if hi < dst[0].shape[0]:
            _StagingRing._write_rows(slot, dst, lo, hi)
        else:
            with span("cgs.pipeline.tail"):
                _StagingRing._write_rows(slot, dst, lo, hi)

    @staticmethod
    def _write_rows(slot: _Slot, dst: list, lo: int, hi: int) -> None:
        for out, host in zip(dst, slot.outs):
            if out is not None:
                out[lo:hi].copy_(host[:hi - lo])

    def synchronize(self) -> None:
        """Wait for every copy and forward the ring has enqueued."""
        if self.upload is not None:
            for stream in (self.upload, self.read_back,
                           torch.cuda.current_stream(self.device)):
                stream.synchronize()


class MaskPipeline:
    """Critic+masker batched inference with optional saliency.

    critic, masker: the critic / `UnetDecoder` modules that fix the
    architecture and compute dtype; params: {'critic', 'masker'[,
    'sepcrit']} state_dicts, or with ensemble=True a sequence of R such
    dicts, one per member (`train/checkpoints.py:load_seed_ensemble`).
    The pipeline keeps its own copies on `device` (default cuda; raises
    without a card).

    eval_mode=True disables dropout (reference `.eval()`,
    main.py:900-909); False (`-noevalmode`) keeps it live, drawing
    from a `torch.Generator` seeded with `seed` (an ensemble's members
    draw from it in member order).

    wire: 'f32' returns soft masks; 'u8' returns floor(255*clip(m,0,1))
    as uint8 (what the -process PNG writers compute from f32 masks) in
    `masks_u8`. hard_threshold: also return (mask >= threshold) as a
    uint8 plane (-process binarisation, main.py:1164).

    quantize: None or 'int8' (eval only: it refuses saliency and
    eval_mode=False). calib: (N, H, W, 3) uint8 calibration frames for
    static int8 activation scales; without it the scales are dynamic,
    and with ensemble=True it is ignored with a warning (a member's
    scales would need a calibration pass of their own).

    `params` holds the host state_dicts being served (for an ensemble,
    the list of members), as given to the last `update_params`.

    mesh: a `parallel.mesh.Mesh` of this rank (module docstring); every
    rank must call `run` / `run_device` alike. With ensemble=True the
    members must divide over the ranks (`parallel.mesh.
    ensemble_mesh_or_none` picks the mesh or None).
    """

    MAX_IN_FLIGHT = 3   # run(): batches in flight, the ring's slots

    def __init__(self, critic, masker,
                 params: Union[Dict, Sequence[Dict]],
                 batch_size: int = 16384,
                 salience: bool = False, eval_mode: bool = True,
                 separate: bool = False, seed: int = 0,
                 wire: str = "f32", hard_threshold: Optional[float] = None,
                 max_in_flight: Optional[int] = None, device=None,
                 mesh=None, ensemble: bool = False,
                 quantize: Optional[str] = None,
                 calib: Optional[np.ndarray] = None):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize={quantize!r} not in "
                             "(None, 'int8')")
        if quantize and salience:
            raise ValueError("quantize='int8' cannot compute saliency "
                             "(no useful input gradient through int8 "
                             "convs); drop one of the two")
        if quantize and not eval_mode:
            raise ValueError("quantize='int8' requires eval_mode=True "
                             "(the quantized forward has no dropout)")
        if quantize and not isinstance(critic, Critic):
            raise ValueError(
                "quantize='int8' runs the paper's Critic only "
                "(ops/quant.py:critic_apply_q), not "
                f"{type(critic).__name__}: serve it without int8")
        if quantize and ensemble and calib is not None:
            warnings.warn(
                "MaskPipeline: calib is ignored with ensemble=True; the "
                "members' int8 activation scales stay dynamic (the JAX "
                "package drops the calibration batch silently, "
                "cgs_tpu/pipeline.py:386)")
        if wire not in ("f32", "u8"):
            raise ValueError(f"wire={wire!r} not in ('f32', 'u8')")
        self.device = resolve_device(device)
        self.critic = critic
        self.masker = masker
        self.mesh = mesh
        self.batch = int(batch_size)
        if mesh is not None:           # keep the ranks' shares even
            self.batch = pad_to_multiple(self.batch, mesh.world)
        self.salience = salience
        self.eval_mode = eval_mode
        self.separate = separate
        self.ensemble = bool(ensemble)
        self.quantize = quantize
        self._calib = calib if quantize and not self.ensemble else None
        self.wire = wire
        self.hard_threshold = (float(hard_threshold)
                               if hard_threshold is not None else None)
        self.max_in_flight = max(1, int(max_in_flight
                                        if max_in_flight is not None
                                        else self.MAX_IN_FLIGHT))
        # the models cast their input to their compute dtype, and a
        # bf16 ingest is the f32 one rounded to bf16: it saves both
        # casts; saliency's input gradient stays f32
        dt = critic.compute_dtype
        self._ingest_dtype = (dt if not salience
                              and masker.compute_dtype == dt
                              else torch.float32)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rank_seed(seed, mesh))
        # one {name: device module} dict per member (one without
        # ensemble); under int8 {name: quantized device state_dict}
        self._members: List[Dict] = []
        self.update_params(params)
        self._ring: Optional[_StagingRing] = None   # made by run()

    def update_params(self, params: Union[Dict, Sequence[Dict]]) -> None:
        """Serve new weights (with ensemble=True, one dict per member):
        the device copies are built off to the side and swapped in by
        one assignment."""
        members = list(params) if self.ensemble else [params]
        if not members:
            raise ValueError("ensemble=True needs at least one member")
        if self.ensemble:     # over a mesh: this rank's R/N (or raises)
            members = seed_shard_tree(self.mesh, members)
        names = ["critic", "masker"] + (["sepcrit"] if self.separate
                                        else [])
        built = [{name: self._device_copy(name, member[name])
                  for name in names} for member in members]
        if self.quantize == "int8":
            built = [self._quantized(m) for m in built]
        self.params = params
        self._members = built          # the swap

    def _device_copy(self, name: str, state: Dict[str, torch.Tensor]):
        """A device module holding `state`, or under int8 the state on
        the device."""
        if self.quantize == "int8":
            return {k: v.detach().to(self.device, torch.float32)
                    for k, v in state.items()}
        template = self.masker if name == "masker" else self.critic
        model = copy.deepcopy(template).to(self.device,
                                           memory_format=torch.channels_last)
        model.load_state_dict(state)
        model.requires_grad_(False)
        return model.train(not self.eval_mode)

    def _quantized(self, member: Dict) -> Dict:
        """One member's f32 state on the device -> its int8 state, with
        static activation scales when calibration frames were given."""
        scales = None
        if self._calib is not None:
            x = normalize_u8(torch.from_numpy(np.ascontiguousarray(
                self._calib)).to(self.device)).permute(0, 3, 1, 2)
            scales = calibrate_act_scales(
                member, x, separate=self.separate,
                compute_dtype=self.critic.compute_dtype)
        q = quantize_tree(member)
        return q if scales is None else merge_act_scales(q, scales)

    def _member_forward(self, models: Dict, x: torch.Tensor, gen) -> tuple:
        """(pred (N,), mask, sal or None) of one member, NHWC."""
        if self.quantize == "int8":
            cdt = self.critic.compute_dtype
            pred, embeds = critic_apply_q(models["critic"], x,
                                          compute_dtype=cdt)
            if self.separate:
                _, embeds = critic_apply_q(models["sepcrit"], x,
                                           compute_dtype=cdt)
            mask = masker_apply_q(models["masker"], x, embeds,
                                  compute_dtype=self.masker.compute_dtype)
            return pred.squeeze(-1), mask.permute(0, 2, 3, 1), None
        critic = functools.partial(critic_forward, models["critic"])
        if self.salience:   # fused forward + input-grad (main.py:949-953)
            pred, embeds, sal = critic_with_saliency(critic, x, gen)
            sal = sal.permute(0, 2, 3, 1)
        else:
            pred, embeds = critic(x, collect=True, generator=gen)
            sal = None
        if self.separate:   # masker reads sepcrit features (main.py:946)
            _, embeds = critic_forward(models["sepcrit"], x, collect=True,
                                       generator=gen)
        mask = masker_forward(models["masker"], x, embeds
                              ).permute(0, 2, 3, 1)
        return pred.squeeze(-1), mask, sal

    def _forward(self, u8: torch.Tensor) -> tuple:
        """(pred, mask, sal[, hard]) for one batch of device frames; over
        a mesh each rank runs its rows and every rank returns the whole
        batch's outputs (a batch that does not divide runs whole on
        every rank)."""
        mesh, n = self.mesh, u8.shape[0]
        if mesh is None or self.ensemble or not mesh.divides(n):
            return self._forward_rows(u8)
        out = self._forward_rows(u8[mesh.rows(n)])
        return tuple(None if t is None else mesh.assemble(t, n)
                     for t in out)

    def _forward_rows(self, u8: torch.Tensor) -> tuple:
        # (N, H, W, 3) -> NCHW view with channels_last strides
        x = normalize_u8(u8, self._ingest_dtype).permute(0, 3, 1, 2)
        gen = None if self.eval_mode else self.generator
        members = self._members      # one weight set for the whole batch
        out = self._member_forward(members[0], x, gen)
        if self.ensemble:
            # the mean over members, before the wire encoding
            # (cgs_tpu/pipeline.py:216-222): f32 sums in member order,
            # over a mesh this rank's members, then summed over the ranks
            for models in members[1:]:
                out = tuple(None if a is None else a.add_(b) for a, b in
                            zip(out, self._member_forward(models, x, gen)))
            if self.mesh is not None:
                out = tuple(None if a is None
                            else self.mesh.all_reduce_(a.contiguous())
                            for a in out)
            r = float(len(members) * (1 if self.mesh is None
                                      else self.mesh.world))
            out = tuple(None if a is None else a.div_(r) for a in out)
        mask = out[1]
        if self.hard_threshold is not None:       # main.py:1164 (>=)
            out += ((mask >= self.hard_threshold).to(torch.uint8),)
        if self.wire == "u8":
            out = (out[0], torch.floor(mask.clamp(0.0, 1.0) * 255.0)
                   .to(torch.uint8)) + out[2:]
        return out

    def place_input(self, frames_u8: np.ndarray) -> torch.Tensor:
        """Host (N, H, W, 3) uint8 frames -> a tensor on the pipeline's
        device (port of `cgs_tpu/pipeline.py:423-435`, unmeshed). The
        copy reads pageable memory, so it is done when this returns and
        the caller may reuse its array."""
        return torch.from_numpy(np.ascontiguousarray(frames_u8)).to(
            self.device)

    def run_device(self, frames_u8: torch.Tensor) -> tuple:
        """Device-resident path: (N, H, W, 3) uint8 frames already on
        the pipeline's device, one forward, outputs stay there."""
        if frames_u8.device != self.device:
            raise ValueError(f"frames on {frames_u8.device}, pipeline on "
                             f"{self.device}")
        with torch.no_grad():
            return self._forward(frames_u8)

    def run(self, frames_u8: np.ndarray) -> PipelineOutput:
        """Host frames -> host outputs, in fixed batches (the last one
        zero-padded) streamed through the staging ring, at most
        max_in_flight batches in flight."""
        with span("cgs.pipeline.run"):
            return self._run(frames_u8)

    def _staging_ring(self, bs: int, frame: tuple,
                      dtype: np.dtype) -> _StagingRing:
        ring = self._ring
        if ring is None or not ring.holds(bs, frame, dtype):
            self._ring = None             # free the old buffers first
            self._ring = _StagingRing(self.max_in_flight, bs, frame, dtype,
                                      self.device)
        return self._ring

    def _run(self, frames_u8: np.ndarray) -> PipelineOutput:
        n = frames_u8.shape[0]
        if n == 0:
            h, w = frames_u8.shape[1:3] or (64, 64)
            zmask = np.zeros((0, h, w, 1), np.float32)
            return PipelineOutput(
                preds=np.zeros((0,), np.float32),
                masks=zmask if self.wire == "f32" else None,
                masks_u8=(np.zeros((0, h, w, 1), np.uint8)
                          if self.wire == "u8" else None),
                hard=(np.zeros((0, h, w, 1), np.uint8)
                      if self.hard_threshold is not None else None),
                saliency=np.zeros((0, h, w, 1), np.float32)
                if self.salience else None)
        bs = min(self.batch, n)
        if self.mesh is not None:       # keep the ranks' shares even
            bs = pad_to_multiple(bs, self.mesh.world)
        ring = self._staging_ring(bs, frames_u8.shape[1:], frames_u8.dtype)
        dst, host = [], []   # the call's outputs, n rows each: tensors
        #                      and their arrays, made at the first unstage
        pending = collections.deque()   # (slot, device outputs, lo, hi)

        def unstage():
            slot, outs, lo, hi = pending[0]
            with span("cgs.pipeline.read_back"):
                if not dst:
                    dst.extend(None if t is None else torch.empty(
                        (n, *t.shape[1:]), dtype=t.dtype) for t in outs)
                    host.extend(None if t is None else t.numpy()
                                for t in dst)
                ring.unstage(slot, dst, lo, hi)
            pending.popleft()   # frees the device outputs: copies done

        def stage(i, lo, hi):
            slot = ring.take(i)
            if hi - lo < bs:                # pad the final ragged batch
                with span("cgs.pipeline.pad"):
                    slot.frames[hi - lo:bs].zero_()
            with span("cgs.pipeline.upload"):
                ring.stage(slot, frames_u8[lo:hi], bs)
            return slot

        try:
            for i, lo in enumerate(range(0, n, bs)):
                if len(pending) == len(ring.slots):
                    unstage()
                hi = min(lo + bs, n)
                if i:
                    slot = stage(i, lo, hi)
                else:           # nothing of the call is on the card yet
                    with span("cgs.pipeline.lead"):
                        slot = stage(i, lo, hi)
                with span("cgs.pipeline.forward"):
                    outs = ring.dispatch(slot, bs, self.run_device)
                pending.append((slot, outs, lo, hi))
                counts["pipeline.rows"] += bs
                counts["pipeline.h2d_bytes"] += bs * frames_u8[:1].nbytes
                counts["pipeline.d2h_bytes"] += sum(
                    t.nbytes for t in outs if t is not None)
                counts["pipeline.staged_batches"] += int(
                    ring.upload is not None)
            while pending:
                unstage()
        except BaseException:
            ring.synchronize()   # no copy may still touch the ring
            raise
        preds, mask_all, sal = host[:3]
        hard = host[3] if self.hard_threshold is not None else None
        if self.wire == "u8":
            return PipelineOutput(preds=preds, masks=None, saliency=sal,
                                  masks_u8=mask_all, hard=hard)
        return PipelineOutput(preds=preds, masks=mask_all, saliency=sal,
                              hard=hard)
