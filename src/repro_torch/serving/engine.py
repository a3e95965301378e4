"""Batched serving engine: prefill + decode over the decode cache (port
of `repro/serving/engine.py`).

A deliberately simple continuous-batching core: fixed decode batch B,
requests occupy slots; prefill runs teacher-forced through the decode
step into the slot's cache rows (exact, and the engine needs one step
function); decode steps advance every live slot one token.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..models.transformer import decode_step, init_cache, init_params
from ..obs.serving import NULL_SERVING_OBS


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    # Compiled-out obs plane (see repro_torch.obs.serving).
    _obs = NULL_SERVING_OBS
    _obs_track = "engine"

    def __init__(self, cfg, params=None, *, batch: int = 8,
                 max_len: int = 512, seed: int = 0, device=None):
        """`params`: the port's parameter dict on `device`; default:
        random parameters from a generator seeded with `seed`."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch = batch
        self.max_len = max_len
        if params is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
            params = init_params(cfg, g, self.device)
        self.params = params
        self.cache = init_cache(cfg, batch, max_len, self.device)
        self.slots: list = [None] * batch
        self.queue: list = []
        self.completed: list = []
        self.steps_used = 0
        self.starved = False            # budget expired with live work

    def submit(self, req: Request):
        self.queue.append(req)

    @property
    def requests_completed(self) -> int:
        return len(self.completed)

    def _assign(self) -> int:
        assigned = 0
        for i in range(self.batch):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.pop(0)
                assigned += 1
        return assigned

    def _reset_cache(self):
        """Every wave starts from a zeroed cache, as the reference's
        engine, which builds a fresh one per wave: K/V, and the mamba2
        layers' ssm and conv state, which decode would otherwise carry
        over from the last wave."""
        for c in self.cache:
            for t in c.values():
                t.zero_()

    def run(self, max_steps: int = 10_000):
        """Lockstep loop: all live slots share the position counter
        (prompts are left-aligned per generation wave).

        `steps_used` counts the decode-step invocations; when
        `max_steps` expires with live slots or queued requests the
        engine sets `starved` and returns what completed."""
        obs, track = self._obs, self._obs_track
        self.steps_used = 0
        self.starved = False
        while (self.queue or any(self.slots)) and max_steps:
            assigned = self._assign()
            live = [r for r in self.slots if r is not None]
            if not live:
                break
            if obs.enabled and assigned:
                obs.tracer.instant(track, "engine/assign",
                                   {"assigned": assigned,
                                    "queued": len(self.queue)})
            wave_prompt = max(len(r.prompt) for r in live)
            wave_new = max(r.max_new for r in live)
            self._reset_cache()
            toks = np.zeros((self.batch,), np.int64)
            if obs.enabled:
                obs.tracer.begin(track, "engine/prefill",
                                 {"live": len(live),
                                  "prompt_len": wave_prompt})
            # teacher-forced prefill (exact; shares the decode step)
            for t in range(wave_prompt + wave_new):
                if obs.enabled and t == wave_prompt:
                    obs.tracer.end(track, "engine/prefill")
                    obs.tracer.begin(track, "engine/decode",
                                     {"live": len(live),
                                      "max_new": wave_new})
                for i, r in enumerate(self.slots):
                    if r is None:
                        continue
                    if t < len(r.prompt):
                        toks[i] = r.prompt[t]
                    elif r.out and not r.done:
                        toks[i] = r.out[-1]
                logits = decode_step(self.params, self.cfg, self.cache,
                                     to_device(toks, self.device), t)
                nxt = logits.argmax(dim=-1).cpu().numpy()
                for i, r in enumerate(self.slots):
                    if r is None or r.done:
                        continue
                    if t >= len(r.prompt) - 1:
                        r.out.append(int(nxt[i]))
                        if len(r.out) >= r.max_new:
                            r.done = True
                max_steps -= 1
                self.steps_used += 1
                if max_steps <= 0:
                    break
            if obs.enabled:
                obs.tracer.end(track)   # close prefill OR decode span
            for i, r in enumerate(self.slots):
                if r is not None and r.done:
                    self.completed.append(r)
                    self.slots[i] = None
        if max_steps <= 0 and (self.queue or any(self.slots)):
            self.starved = True
            if obs.enabled:
                obs.tracer.instant(
                    track, "engine/starved",
                    {"steps_used": self.steps_used,
                     "live_slots": sum(r is not None
                                       for r in self.slots),
                     "queued": len(self.queue),
                     "completed": len(self.completed)})
        if obs.enabled:
            obs.tracer.counter(track, "engine",
                               {"steps_used": self.steps_used,
                                "completed": len(self.completed)})
        return self.completed
