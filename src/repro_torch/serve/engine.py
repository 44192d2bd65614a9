"""Serving engines over the paged, segment-aware KV cache.

Port of ``repro/serve/engine.py``:

  Engine            — fixed-batch API: one prefill, lock-step decode.  Ragged
                      right-padded prompts via ``prompt_lens``; finished rows
                      freeze to ``eos_id`` / logprob 0.
  ContinuousEngine  — continuous batching over a ``rows x lanes`` grid of
                      request slots sharing one cache; admitted prompts are
                      packed into one prefill chunk per step, and every live
                      lane decodes in one (rows, lanes) step, each gated to
                      its own segment of its cache row.

Both run on the card unless the caller asks for the CPU: ``device=None``
means ``cuda``, and raises when no CUDA device is present.  The cache is
written in place (see models/attention.py).

Sharded serving: ``Engine`` given one rank's core/layout.py::GridParams
(train/trainer.py::grid_params) runs that rank of a (data, model) grid
(models/transformer.py::prefill_grid, decode_step_grid): every rank calls
``generate`` with the same prompts, takes its data index's rows, holds
its blocks of the weights and of the cache (the reference's rules), and
decodes until every row of the grid is done, a decision all ranks take
together.  Rank 0 returns the whole batch's result, the others None.
Sampling draws from a generator seeded by the rank's data index.  The
ContinuousEngine is not served on a grid (ROADMAP A9.4b).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import Config
from repro_torch.core.layout import GridParams
from repro_torch.models import Transformer, decode_step, decode_step_grid, prefill, prefill_grid
from repro_torch.models.transformer import cache_specs, grid_serving_refusal

# The kinds whose state is a paged, segment-aware cache that packed rows can
# share; recurrent, xLSTM and cross-attention state is per row, so
# ContinuousEngine refuses them, as the reference's does.
_PAGEABLE_KINDS = ("attn", "swa", "local")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card.  Raises when
    a CUDA device is asked for and none is present — there is no silent CPU
    run."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, steps)
    logprobs: np.ndarray  # (B, steps)
    steps: int


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray  # (n,)
    logprobs: np.ndarray  # (n,)
    canceled: bool = False


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return x - m - np.log(e.sum(axis=-1, keepdims=True))


class _Model:
    """The weights on ``device`` and their compute-dtype copy."""

    def __init__(self, cfg: Config, params: Dict, device):
        self.device = resolve_device(device)
        self.module = Transformer(cfg.model, params).to(self.device)
        self.params = self.module.compute_params(getattr(torch, cfg.parallel.compute_dtype))


class Engine:
    """``params``: the weights tree, or one rank's GridParams (sharded
    serving, module note; ``device`` then None or the rank's)."""

    def __init__(self, cfg: Config, params, cache_len: int = 0, eos_id: int = -1,
                 device=None):
        self.cfg = cfg
        self.grid = params if isinstance(params, GridParams) else None
        if self.grid is None:
            self.model = _Model(cfg, params, device)
            self.device = self.model.device
        else:
            grid_serving_refusal(cfg.model)
            self.device = self.grid.device
            if device is not None and torch.device(device) != self.device:
                raise ValueError(f"device {device} differs from the rank's {self.device}")
            self.placement = self.grid.placement
            self._specs = {}  # the cache's spec tree by the grid's batch
        self.eos_id = eos_id
        self.cache_len = cache_len or (cfg.seq_len + 64)

    def _cache_specs(self, rows: int):
        """The cache's spec tree (cache_specs) for ``rows`` rows on each
        data rank, computed once for a batch size."""
        b = rows * self.placement.mesh.shape[self.placement.dp]
        if b not in self._specs:
            self._specs[b] = cache_specs(self.cfg.model, self.cfg.parallel, self.placement.rules,
                                         b, self.cache_len)
        return self._specs[b]

    def _prefill(self, tokens, **kw):
        if self.grid is not None:
            return prefill_grid(self.cfg.model, self.cfg.parallel, self.grid.tree, tokens,
                                self.placement, cache_len=self.cache_len,
                                specs=self._cache_specs(tokens.shape[0]), **kw)
        return prefill(self.cfg.model, self.cfg.parallel, self.model.params, tokens,
                       cache_len=self.cache_len, **kw)

    def _decode(self, cache, tok, pos):
        if self.grid is not None:
            return decode_step_grid(self.cfg.model, self.cfg.parallel, self.grid.tree, cache, tok,
                                    pos, self.placement, cache_len=self.cache_len,
                                    specs=self._cache_specs(tok.shape[0]))
        return decode_step(self.cfg.model, self.cfg.parallel, self.model.params, cache, tok, pos)

    def rows(self, b: int) -> slice:
        """The rows of a batch of ``b`` that this engine serves: all of
        them, or on a grid its data index's share (the data axis must divide
        ``b``)."""
        if self.grid is None:
            return slice(0, b)
        pl = self.placement
        d = pl.mesh.shape[pl.dp]
        if b % d:
            raise ValueError(f"a batch of {b} rows does not split over {d} data ranks")
        n = b // d
        return slice(pl.data_index * n, (pl.data_index + 1) * n)

    def _all_done(self, done: torch.Tensor) -> bool:
        if self.grid is None:
            return bool(done.all())
        return not self.placement.any_rank(not bool(done.all()))

    def _gather_rows(self, x: np.ndarray) -> Optional[np.ndarray]:
        """The data ranks' rows of ``x`` in data order on rank 0 (None on
        the other ranks): one gather of every rank's rows (on the CPU over
        gloo, on the card over NCCL), the model index 0 ranks' kept."""
        mesh = self.placement.mesh
        dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
        parts = mesh.gather(torch.as_tensor(x, device=dev), dst=0)
        if parts is None:
            return None
        tp = self.placement.tp
        return np.concatenate([parts[r].cpu().numpy() for r in range(mesh.size)
                               if mesh.coords_of(r)[tp] == 0])

    @torch.no_grad()
    def generate(
        self,
        prompts: np.ndarray,
        max_new_tokens: int,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
        extra: Optional[Dict] = None,
        prompt_lens: Optional[np.ndarray] = None,
    ) -> GenerationResult:
        """Greedy (temperature 0) or sampled generation.  extra: the
        cross-attention's source, {"frames": (B,F,d)} or {"image": (B,N,d)}
        (arrays or tensors), for the models that take one; the decode steps
        read its projection from the cache.  prompt_lens: (B,) true lengths
        of right-padded ragged prompts — pads get position -1, never enter
        the cache, and each row decodes at its own position.  One decode
        runs after every emitted token, the last one included, as in the
        reference loop.  On a grid every rank passes the whole batch and
        serves its rows; rank 0 returns the whole result, the others None."""
        rows = self.rows(len(prompts))
        prompts = np.asarray(prompts)[rows]
        if prompt_lens is not None:
            prompt_lens = np.asarray(prompt_lens)[rows]
        if extra is not None:
            extra = {k: v[rows] for k, v in extra.items()}
        b, s = prompts.shape
        dev = self.device
        toks_in = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
        if extra is not None:
            extra = {k: torch.as_tensor(v, device=dev) for k, v in extra.items()}
        if prompt_lens is None:
            logits, cache = self._prefill(toks_in, extra=extra)
            pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        else:
            lens = np.asarray(prompt_lens, np.int32)
            if lens.shape != (b,) or lens.min() < 1 or lens.max() > s:
                raise ValueError(f"prompt_lens must be (B,) in [1, {s}], got {lens!r}")
            ar = np.arange(s, dtype=np.int32)[None, :]
            positions = np.where(ar < lens[:, None], ar, -1).astype(np.int32)
            gidx = (lens - 1)[:, None].astype(np.int32)
            logits, cache = self._prefill(
                toks_in, positions=torch.as_tensor(positions, device=dev),
                gather_idx=torch.as_tensor(gidx, device=dev), extra=extra,
            )
            pos = torch.as_tensor(lens, device=dev)
        if generator is None and temperature > 0:  # on a grid, one per data index
            seed = 0 if self.grid is None else self.placement.data_index
            generator = torch.Generator(device=dev).manual_seed(seed)
        tok = logits[:, -1].argmax(dim=-1)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        eos = torch.tensor(self.eos_id, device=dev)
        outs: List[np.ndarray] = []
        lps: List[np.ndarray] = []
        for _ in range(max_new_tokens):
            # rows finished BEFORE this step freeze to eos_id / logprob 0;
            # the first EOS itself is emitted with its true logprob
            frozen = done
            outs.append(torch.where(frozen, eos, tok).to(torch.int32).cpu().numpy())
            lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
            lp_tok = lp.gather(1, tok[:, None])[:, 0]
            lps.append(torch.where(frozen, 0.0, lp_tok).cpu().numpy())
            done = done | (tok == self.eos_id)
            if self._all_done(done):
                break
            logits, cache = self._decode(cache, tok[:, None], pos)
            pos = pos + 1
            if temperature > 0:
                probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                tok = logits[:, -1].argmax(dim=-1)
        if outs:
            t_out, l_out = np.stack(outs, axis=1), np.stack(lps, axis=1)
        else:  # max_new_tokens == 0: empty, (B, 0)-shaped
            t_out = np.zeros((b, 0), np.int32)
            l_out = np.zeros((b, 0), np.float32)
        if self.grid is not None:
            t_out, l_out = self._gather_rows(t_out), self._gather_rows(l_out)
            if t_out is None:
                return None
        return GenerationResult(tokens=t_out, logprobs=l_out, steps=len(outs))


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    temperature: float
    row: int = -1
    lane: int = -1
    seg: int = -1
    offset: int = -1  # prompt offset inside this step's prefill chunk
    next_pos: int = 0  # position of the next token fed to decode
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    done: bool = False
    canceled: bool = False


class ContinuousEngine:
    """Continuous batching over a (rows x lanes) grid of request slots.

    rows:      cache batch dimension (one paged cache row each).
    lanes:     decode slots per row, each gated to its own segment.
    cache_len: KV slots per row; a request needs len(prompt) + max_new.
    chunk:     prefill chunk width; a prompt must fit in one chunk.

    Restricted to pure-attention block patterns (attn/swa/local).  Sampling
    runs on the host with a numpy generator seeded by ``seed``, as in the
    reference, so the same logits give the same tokens.
    """

    def __init__(self, cfg: Config, params: Dict, *, rows: int = 2, lanes: int = 2,
                 cache_len: int = 0, chunk: int = 0, eos_id: int = -1, seed: int = 0,
                 device=None):
        if isinstance(params, GridParams):
            raise NotImplementedError("ContinuousEngine on a grid (its packed rows' admission "
                                      "and resets across the ranks' cache blocks): ROADMAP "
                                      "A9.4b")
        bad = [k for k in tuple(cfg.model.block_pattern) + tuple(cfg.model.tail_kinds())
               if k not in _PAGEABLE_KINDS]
        if bad:
            raise NotImplementedError(
                f"ContinuousEngine needs a pure-attention pattern {_PAGEABLE_KINDS}, "
                f"got {bad!r} — recurrent/xLSTM state is not segment-pageable"
            )
        self.cfg = cfg
        self.model = _Model(cfg, params, device)
        self.device = self.model.device
        self.rows = rows
        self.lanes = lanes
        self.cache_len = cache_len or (cfg.seq_len + 64)
        self.chunk = chunk or cfg.seq_len
        self.eos_id = eos_id
        self._rng = np.random.default_rng(seed)
        with torch.no_grad():
            # an all-pad prefill builds an EMPTY cache: nothing scatters
            t0 = torch.zeros((rows, 1), dtype=torch.int64, device=self.device)
            p0 = torch.full((rows, 1), -1, dtype=torch.int32, device=self.device)
            self.cache = prefill(cfg.model, cfg.parallel, self.model.params, t0,
                                 cache_len=self.cache_len, positions=p0)[1]

        self._next_rid = 0
        self._reqs: Dict[int, _Request] = {}
        self._queue: collections.deque = collections.deque()
        self._active: set = set()
        self._finished_this_step: List[int] = []
        self._row_live: List[set] = [set() for _ in range(rows)]
        self._free_lanes: List[set] = [set(range(lanes)) for _ in range(rows)]
        self._row_reserved: List[int] = [0] * rows
        self._row_next_seg: List[int] = [0] * rows

    # -- request API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.chunk:
            raise ValueError(f"prompt ({len(prompt)}) exceeds prefill chunk ({self.chunk})")
        if len(prompt) + max_new_tokens > self.cache_len:
            raise ValueError(
                f"prompt + max_new_tokens ({len(prompt)} + {max_new_tokens}) "
                f"exceeds cache_len ({self.cache_len})"
            )
        rid = self._next_rid
        self._next_rid += 1
        self._reqs[rid] = _Request(rid, prompt, max_new_tokens, temperature)
        self._queue.append(rid)
        return rid

    def cancel(self, rid: int) -> None:
        """Evict a request: queued -> dropped, active -> its lane frees next
        step (tokens emitted so far are kept in the result)."""
        r = self._reqs[rid]
        r.canceled = True
        if rid in self._queue:
            self._queue.remove(rid)
            r.done = True
        elif not r.done:
            self._finish(r)

    def result(self, rid: int) -> RequestResult:
        r = self._reqs[rid]
        return RequestResult(
            rid=rid,
            tokens=np.asarray(r.tokens, np.int32),
            logprobs=np.asarray(r.logprobs, np.float32),
            canceled=r.canceled,
        )

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return len(self._active)

    # -- internals ----------------------------------------------------------

    def _finish(self, r: _Request) -> None:
        r.done = True
        self._active.discard(r.rid)
        self._row_live[r.row].discard(r.rid)
        self._free_lanes[r.row].add(r.lane)
        self._finished_this_step.append(r.rid)

    def _sample(self, r: _Request, logits: np.ndarray) -> None:
        """Sample from one (V,) logits vector, emit, and update liveness."""
        lp = _log_softmax(logits)
        if r.temperature > 0:
            pz = np.exp(lp / np.float32(r.temperature))
            pz = pz / pz.sum()
            tok = int(self._rng.choice(len(pz), p=pz))
        else:
            tok = int(np.argmax(logits))
        r.tokens.append(tok)
        r.logprobs.append(float(lp[tok]))
        if tok == self.eos_id or len(r.tokens) >= r.max_new:
            self._finish(r)

    def _layer_caches(self):
        for gc in self.cache["groups"]:
            for blk in gc.values():
                yield blk["self"]
        for blk in self.cache["tail"]:
            yield blk["self"]

    def _reset_drained_rows(self) -> None:
        rows = [i for i in range(self.rows)
                if not self._row_live[i] and self._row_reserved[i] > 0]
        if not rows:
            return
        idx = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        for c in self._layer_caches():
            c["kpos"][idx] = -1
            c["kseg"][idx] = -1
            c["fill"][idx] = 0
            c["k"][idx] = 0
            c["v"][idx] = 0
        for i in rows:
            self._row_reserved[i] = 0
            self._row_next_seg[i] = 0

    def _admit(self):
        """FIFO first-fit: place queued prompts into rows with a free lane,
        enough reserved capacity, and room in this step's prefill chunk."""
        admits: List[_Request] = []
        chunk_used = [0] * self.rows
        seg_base = list(self._row_next_seg)  # snapshot BEFORE this step's segs
        for rid in list(self._queue):
            r = self._reqs[rid]
            need = len(r.prompt) + r.max_new
            for row in range(self.rows):
                if not self._free_lanes[row]:
                    continue
                if self._row_reserved[row] + need > self.cache_len:
                    continue
                if chunk_used[row] + len(r.prompt) > self.chunk:
                    continue
                r.row = row
                r.lane = min(self._free_lanes[row])
                self._free_lanes[row].discard(r.lane)
                r.seg = self._row_next_seg[row]
                self._row_next_seg[row] += 1
                r.offset = chunk_used[row]
                chunk_used[row] += len(r.prompt)
                self._row_reserved[row] += need
                self._row_live[row].add(rid)
                self._active.add(rid)
                self._queue.remove(rid)
                admits.append(r)
                break
        return admits, np.asarray(seg_base, np.int32)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    @torch.no_grad()
    def step(self) -> Dict:
        """One scheduler tick: reclaim drained rows, admit + prefill queued
        prompts as one packed chunk, then decode every live lane once."""
        m, p = self.cfg.model, self.cfg.parallel
        self._finished_this_step = []
        self._reset_drained_rows()

        admits, seg_base = self._admit()
        if admits:
            toks = np.zeros((self.rows, self.chunk), np.int64)
            poss = np.full((self.rows, self.chunk), -1, np.int32)
            gidx = np.zeros((self.rows, self.lanes), np.int32)
            for r in admits:
                n = len(r.prompt)
                toks[r.row, r.offset:r.offset + n] = r.prompt
                poss[r.row, r.offset:r.offset + n] = np.arange(n, dtype=np.int32)
                gidx[r.row, r.lane] = r.offset + n - 1
            logits, self.cache = prefill(
                m, p, self.model.params, self._t(toks), cache_len=self.cache_len,
                cache=self.cache, positions=self._t(poss), seg_base=self._t(seg_base),
                gather_idx=self._t(gidx),
            )
            lg = logits.float().cpu().numpy()  # (rows, lanes, V)
            for r in admits:
                r.next_pos = len(r.prompt)
                if r.max_new == 0:
                    self._finish(r)
                else:
                    self._sample(r, lg[r.row, r.lane])

        live = [self._reqs[rid] for rid in sorted(self._active)]
        if live:
            tok = np.zeros((self.rows, self.lanes), np.int64)
            pos = np.full((self.rows, self.lanes), -1, np.int32)
            seg = np.full((self.rows, self.lanes), -1, np.int32)
            for r in live:
                tok[r.row, r.lane] = r.tokens[-1]
                pos[r.row, r.lane] = r.next_pos
                seg[r.row, r.lane] = r.seg
            logits, self.cache = decode_step(
                m, p, self.model.params, self.cache, self._t(tok), self._t(pos),
                segments=self._t(seg),
            )
            lg = logits.float().cpu().numpy()
            for r in live:
                r.next_pos += 1
                self._sample(r, lg[r.row, r.lane])

        return {
            "admitted": len(admits),
            "decoded": len(live),
            "finished": list(self._finished_this_step),
            "pending": self.pending,
            "active": self.active,
        }

    def run(self, max_steps: int = 10_000) -> None:
        """Drive step() until every submitted request has finished."""
        for _ in range(max_steps):
            if not self._queue and not self._active:
                return
            self.step()
        raise RuntimeError(f"ContinuousEngine.run did not drain in {max_steps} steps")
