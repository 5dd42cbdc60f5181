"""Batched mask inference, the `-process`/`-eval` forward path (PyTorch
port of `cgs_tpu/pipeline.py`; reference main.py:1130-1151 / 935-956).

One forward per batch: uint8 NHWC frames are ingested by the
`normalize_u8` kernel, viewed as NCHW channels_last with no copy, run
through the critic (with its feature pyramid and, optionally, the
input-gradient saliency from the same pass) and the decoder, whose 6
up-steps are the `upsample2x` kernel; the outputs are encoded for the
wire on the device. Inputs and outputs keep the JAX package's layout:
frames (N, H, W, 3) uint8, masks (N, H, W, 1).

`run` chunks host frames into fixed batches, zero-pads the last one,
and keeps at most `max_in_flight` chunks of outputs on the device.
`run_device` is the device-resident path.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from cgs_tpu_torch.core.device import resolve_device
from cgs_tpu_torch.ops.kernels import normalize_u8
from cgs_tpu_torch.ops.saliency import critic_with_saliency


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


class MaskPipeline:
    """Critic+masker batched inference with optional saliency.

    critic, masker: the `Critic` / `UnetDecoder` modules that fix the
    architecture and compute dtype; params: {'critic', 'masker'[,
    'sepcrit']} state_dicts. The pipeline keeps its own copies on
    `device` (default cuda; raises without a card).

    eval_mode=True disables dropout (reference `.eval()`,
    main.py:900-909); False (`-noevalmode`) keeps it live, drawing
    from a `torch.Generator` seeded with `seed`.

    wire: 'f32' returns soft masks; 'u8' returns floor(255*clip(m,0,1))
    as uint8 (what the -process PNG writers compute from f32 masks) in
    `masks_u8`. hard_threshold: also return (mask >= threshold) as a
    uint8 plane (-process binarisation, main.py:1164).
    """

    MAX_IN_FLIGHT = 3   # run(): chunks of outputs alive on the device

    def __init__(self, critic, masker, params: Dict, batch_size: int = 16384,
                 salience: bool = False, eval_mode: bool = True,
                 separate: bool = False, seed: int = 0,
                 wire: str = "f32", hard_threshold: Optional[float] = None,
                 max_in_flight: Optional[int] = None, device=None,
                 mesh=None, ensemble: bool = False,
                 quantize: Optional[str] = None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: multi-device inference is not ported yet "
                "(ROADMAP.md queue 1 item 9, parallel/mesh.py)")
        if ensemble:
            raise NotImplementedError(
                "ensemble: the mean-mask ensemble is not ported yet "
                "(ROADMAP.md queue 1 item 9)")
        if quantize is not None:
            raise NotImplementedError(
                "quantize: int8 inference is not ported yet (ROADMAP.md "
                "queue 1 item 9, ops/quant.py)")
        if wire not in ("f32", "u8"):
            raise ValueError(f"wire={wire!r} not in ('f32', 'u8')")
        self.device = resolve_device(device)
        self.critic = critic
        self.masker = masker
        self.batch = int(batch_size)
        self.salience = salience
        self.eval_mode = eval_mode
        self.separate = separate
        self.wire = wire
        self.hard_threshold = (float(hard_threshold)
                               if hard_threshold is not None else None)
        self.max_in_flight = max(1, int(max_in_flight
                                        if max_in_flight is not None
                                        else self.MAX_IN_FLIGHT))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._models: Dict[str, torch.nn.Module] = {}
        self.update_params(params)

    def update_params(self, params: Dict) -> None:
        """Copy new weights into the pipeline's device modules."""
        names = ["critic", "masker"] + (["sepcrit"] if self.separate
                                        else [])
        for name in names:
            model = self._models.get(name)
            if model is None:
                template = self.masker if name == "masker" else self.critic
                model = copy.deepcopy(template).to(
                    self.device, memory_format=torch.channels_last)
                model.requires_grad_(False)
                model.train(not self.eval_mode)
                self._models[name] = model
            model.load_state_dict(params[name])

    def _forward(self, u8: torch.Tensor) -> tuple:
        """(pred, mask, sal[, hard]) for one batch of device frames."""
        # (N, H, W, 3) f32 -> NCHW view with channels_last strides
        x = normalize_u8(u8).permute(0, 3, 1, 2)
        gen = None if self.eval_mode else self.generator
        critic = self._models["critic"]
        if self.salience:   # fused forward + input-grad (main.py:949-953)
            pred, embeds, sal = critic_with_saliency(critic, x, gen)
            sal = sal.permute(0, 2, 3, 1)
        else:
            pred, embeds = critic(x, collect=True, generator=gen)
            sal = None
        if self.separate:   # masker reads sepcrit features (main.py:946)
            _, embeds = self._models["sepcrit"](x, collect=True,
                                                generator=gen)
        mask = self._models["masker"](x, embeds).permute(0, 2, 3, 1)
        out = (pred.squeeze(-1), mask, sal)
        if self.hard_threshold is not None:       # main.py:1164 (>=)
            out += ((mask >= self.hard_threshold).to(torch.uint8),)
        if self.wire == "u8":
            out = (out[0], torch.floor(mask.clamp(0.0, 1.0) * 255.0)
                   .to(torch.uint8)) + out[2:]
        return out

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
        zero-padded), with at most max_in_flight chunks of outputs alive
        on the device."""
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
        with_hard = self.hard_threshold is not None
        preds, masks, sals, hards = [], [], [], []

        def read_back(fut):
            pred, mask, sal = fut[0], fut[1], fut[2]
            preds.append(pred.cpu().numpy())
            masks.append(mask.cpu().numpy())
            if sal is not None:
                sals.append(sal.cpu().numpy())
            if with_hard:
                hards.append(fut[3].cpu().numpy())

        pending = []
        for lo in range(0, n, bs):
            chunk = frames_u8[lo:lo + bs]
            if chunk.shape[0] < bs:  # pad final ragged batch
                pad = bs - chunk.shape[0]
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:],
                                     chunk.dtype)], axis=0)
            # at most max_in_flight chunks of outputs stay alive on the
            # device (read-back shares the compute stream, so it does
            # not overlap the next chunk's compute yet)
            pending.append(self.run_device(torch.from_numpy(
                np.ascontiguousarray(chunk)).to(self.device)))
            if len(pending) >= self.max_in_flight:
                read_back(pending.pop(0))
        for fut in pending:
            read_back(fut)

        preds = np.concatenate(preds)[:n]
        mask_all = np.concatenate(masks)[:n]
        sal = np.concatenate(sals)[:n] if sals else None
        hard = np.concatenate(hards)[:n] if hards else None
        if self.wire == "u8":
            return PipelineOutput(preds=preds, masks=None, saliency=sal,
                                  masks_u8=mask_all, hard=hard)
        return PipelineOutput(preds=preds, masks=mask_all, saliency=sal,
                              hard=hard)
