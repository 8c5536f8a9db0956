"""Batched decode engine with slot-based continuous batching.

Requests occupy fixed batch slots; finished slots are refilled from the
queue each step (decode-time continuous batching). The KV state is
allocated once at ``max_len`` and reused across requests per slot.

Slot refill uses a *batched prefill*: the prompts of every newly seated
request of one prompt length go through one batched decode call per
prompt token, and the resulting per-request state is scattered into the
engine's batched decode state at the refilled slot rows. Each slot
carries its own decode position (``attention_decode`` accepts per-row
positions), so a refilled request's cache and RoPE phases are coherent
regardless of how far other slots have decoded. Grouping by exact length
means no pad tokens ever enter the state. The JAX package buckets each
group's batch to a power of two to bound XLA compiles; eager PyTorch
compiles nothing, so the groups run at their own size.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # step-level latency accounting (wall-clock seconds, perf_counter)
    t_submit: Optional[float] = None
    t_start: Optional[float] = None       # seated in a slot (prefill begins)
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_start is None:
            return None
        return self.t_start - self.t_submit


class DecodeEngine:
    """``params`` must live on ``device``, which holds the decode state."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_len: int = 128, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.completed: List[Request] = []
        self._state = lm.init_decode_state(cfg, max_batch, max_len,
                                           device=self.device)
        self._toks = torch.zeros((max_batch,), dtype=torch.long,
                                 device=self.device)
        # per-slot absolute decode position (requests start at different
        # times; attention_decode takes a position vector)
        self._slot_pos = np.zeros(max_batch, np.int64)
        self.step_times_s: List[float] = []

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    # -- batched prefill ---------------------------------------------------
    def _prefill(self, prompts: torch.Tensor):
        """Decode state of ``n`` fresh requests of one prompt length ``L``
        (prompts: (n, L)): one batched decode call per token of
        ``prompts[:, :-1]`` from position 0; the last token is decoded by
        the next engine step."""
        n, L = prompts.shape
        state = lm.init_decode_state(self.cfg, n, self.max_len,
                                     device=self.device)
        for pos in range(L - 1):
            _, state = lm.decode_step(self.params, self.cfg, state,
                                      prompts[:, pos], pos)
        return state

    def _scatter_state(self, slot_idx: List[int], new_state) -> None:
        """Write per-request decode state rows into the batched engine state
        at ``slot_idx``, in place. Scanned stacks carry a leading group
        axis, so their batch axis is 1; unscanned ("tail") leaves batch at
        axis 0."""
        idx = torch.as_tensor(slot_idx, dtype=torch.long,
                              device=self.device)
        n = len(slot_idx)

        def put(big, small, axis):
            if isinstance(big, dict):
                for k in big:
                    put(big[k], small[k], axis)
                return
            sel = (slice(None),) * axis + (idx,)
            rows = (slice(None),) * axis + (slice(0, n),)
            big[sel] = small[rows].to(big.dtype)

        for key, big in self._state["layers"].items():
            put(big, new_state["layers"][key], 1 if key == "scan" else 0)

    def _fill_slots(self) -> None:
        refills: List[Tuple[int, Request]] = []
        for i, s in enumerate(self.slots):
            if (s is None or s.done) and self.queue:
                req = self.queue.pop(0)
                req.t_start = time.perf_counter()
                self.slots[i] = req
                refills.append((i, req))
        if not refills:
            return
        # one batched prefill per distinct prompt length: no pad tokens
        # ever reach the state
        by_len: Dict[int, List[Tuple[int, Request]]] = {}
        for i, r in refills:
            by_len.setdefault(len(r.prompt), []).append((i, r))
        toks = self._toks.cpu().clone()
        for L, group in by_len.items():
            mat = torch.tensor([r.prompt for _, r in group],
                               dtype=torch.long, device=self.device)
            with obs.span("engine.prefill", "engine", n_requests=len(group),
                          prompt_len=L):
                new_state = self._prefill(mat)
                self._scatter_state([i for i, _ in group], new_state)
            for i, r in group:
                toks[i] = r.prompt[-1]
                # prompt prefix state covers positions 0..L-2; the last
                # prompt token is decoded next step at its position L-1
                self._slot_pos[i] = L - 1
        self._toks = toks.to(self.device)

    def step(self) -> Dict[int, int]:
        """Decode one token for every active slot; returns {rid: token}."""
        t0 = time.perf_counter()
        self._fill_slots()
        if all(s is None or s.done for s in self.slots):
            return {}
        _obs = obs.enabled()
        _t0 = obs.now_ns() if _obs else 0
        logits, self._state = lm.decode_step(
            self.params, self.cfg, self._state, self._toks,
            torch.tensor(self._slot_pos, device=self.device))
        if _obs:
            obs.complete("engine.decode_step", _t0, cat="engine", args={
                "active": sum(s is not None and not s.done
                              for s in self.slots),
                "max_batch": self.max_batch})
        self._slot_pos += 1
        nxt = torch.argmax(logits, dim=-1).cpu()
        out = {}
        toks = self._toks.cpu().clone()
        now = time.perf_counter()
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            tok = int(nxt[i])
            req.out.append(tok)
            if req.t_first_token is None:
                req.t_first_token = now
            out[req.rid] = tok
            toks[i] = tok
            if len(req.out) >= req.max_new_tokens:
                req.done = True
                req.t_done = now
                self.completed.append(req)
        self._toks = toks.to(self.device)
        self.step_times_s.append(time.perf_counter() - t0)
        return out

    def drain_completed(self) -> List[Request]:
        """Return finished requests accumulated so far and clear the list
        (fleet routers poll this between slices)."""
        done, self.completed = self.completed, []
        return done

    def run_until_done(self, max_steps: int = 1000) -> List[Request]:
        """Run until queue and slots are exhausted; returns the requests
        that completed during THIS call (a finished request whose slot was
        refilled is kept, not dropped). Earlier completions stay in the
        ``completed`` accumulator until ``drain_completed``."""
        already = len(self.completed)
        for _ in range(max_steps):
            if not self.queue and all(s is None or s.done
                                      for s in self.slots):
                break
            self.step()
        return list(self.completed[already:])
