"""``repro_torch.core.compiler`` - the batched placement compiler
(DESIGN.md SS.6).

A :class:`PlacementCompiler` is the fleet-wide LUT build service: it
deduplicates ``(substrate variant, model shape, solver, slice, slowdown)``
keys and builds each missing :class:`~repro_torch.core.placement.PlacementLUT`
exactly once through the batched solver drivers
(:func:`repro_torch.core.placement.build_lut` with ``batched=True``), caching
the result. Fleet bring-up compiles every distinct engine shape in one
pass instead of once per engine, and straggler rescaling (the
scheduler's per-slowdown-signature LUT rebuild) hits the shared cache,
so two degraded engines of the same shape pay one rebuild between them.

Construct through ``repro_torch.api.compiler()``; ``api.scheduler``,
``api.engine`` and ``api.fleet`` accept a ``compiler=`` to share one
cache across engines, fleets and slices.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

from repro_torch import obs
from repro_torch.core.energy import EnergyModel
from repro_torch.core.placement import LUTEntry, PlacementLUT, build_lut_grid
from repro_torch.core.solvers import (LUTMethodSolver, PlacementSolver,
                                      make_solver)
from repro_torch.device import DEFAULT_DEVICE

CacheKey = Tuple

#: serialized LUT-cache format version (bump on incompatible changes;
#: load() skips files with a different version instead of raising)
CACHE_FORMAT_VERSION = 1


def _key_to_jsonable(key):
    """Cache keys are nested tuples of str/int/float; JSON stores them
    as nested lists."""
    if isinstance(key, tuple):
        return [_key_to_jsonable(k) for k in key]
    return key


def _key_from_jsonable(key):
    if isinstance(key, list):
        return tuple(_key_from_jsonable(k) for k in key)
    return key


def slowdown_signature(time_scale) -> tuple:
    """Canonical per-cluster slowdown key. The single source of truth
    for slowdown rounding: the scheduler's per-engine ``_lut_cache`` and
    this compiler's shared cache both key through it, so the two layers
    always address the same entry (DESIGN.md SS.6)."""
    return tuple(sorted((c, round(float(f), 3))
                        for c, f in dict(time_scale).items()))


class PlacementCompiler:
    """Batch LUT builder with one shared cache across engines and fleets.

    ``device`` is where solvers named by string build (a solver instance
    keeps its own); LUTs are byte-identical on either device, so the
    cache key leaves it out."""

    def __init__(self, device=DEFAULT_DEVICE) -> None:
        self.device = device
        self._cache: Dict[CacheKey, PlacementLUT] = {}
        self.n_builds = 0          # cache misses -> actual solver runs
        self.n_hits = 0            # served from cache
        self.n_loaded = 0          # entries merged in by load() warm starts
        # per-build lut_pipeline device ("cuda" / "cpu"; "host" for the
        # closed-form / fixed / per-point paths): which engine actually
        # built each cache miss
        self.n_builds_by_backend: Dict[str, int] = {}

    def _record_build(self, lut: PlacementLUT) -> None:
        b = getattr(lut, "backend", None) or "host"
        self.n_builds += 1
        self.n_builds_by_backend[b] = self.n_builds_by_backend.get(b, 0) + 1
        obs.metrics().counter("compiler.lut.build")

    # -- keys ---------------------------------------------------------------
    @staticmethod
    def cache_key(*, variant_key: tuple, model, solver_name: str,
                  t_slice_ns: float, n_points: int, rho: float,
                  static_window: str, slowdown: tuple) -> CacheKey:
        return (tuple(variant_key), model.name, int(model.n_params),
                solver_name, float(t_slice_ns), int(n_points), float(rho),
                static_window, tuple(slowdown))

    # -- single build -------------------------------------------------------
    def lut(self, em: EnergyModel, *,
            solver: Union[str, PlacementSolver],
            t_slice_ns: float, n_points: int,
            static_window: str = "t_constraint",
            variant_key: Optional[tuple] = None) -> PlacementLUT:
        """Build-or-fetch one LUT. ``em.time_scale`` (straggler slowdown)
        and ``em.rho`` are part of the key, so a degraded engine gets its
        own entry while identical engines share one."""
        sol = make_solver(solver, device=self.device)
        key = self.cache_key(
            variant_key=variant_key or (em.arch.name,), model=em.model,
            solver_name=sol.name, t_slice_ns=t_slice_ns,
            n_points=n_points, rho=em.rho, static_window=static_window,
            slowdown=slowdown_signature(em.time_scale))
        hit = self._cache.get(key)
        # cache traffic is mirrored into the metrics registry
        # unconditionally (rare events): the fleet CLI's lut-cache line
        # and the flight recorder's lut_cache frame field read it there
        if hit is not None:
            self.n_hits += 1
            obs.metrics().counter("compiler.lut.hit")
            return hit
        with obs.span("compiler.lut_build", "compiler",
                      variant=str(key[0]), model=key[1],
                      solver=sol.name, n_points=n_points) as sp_:
            built = sol.build_lut(em, t_slice_ns=t_slice_ns,
                                  n_points=n_points,
                                  static_window=static_window)
            sp_.set("backend", getattr(built, "backend", None) or "host")
        self._record_build(built)
        self._cache[key] = built
        return built

    def lut_grid(self, ems, *, solver: Union[str, PlacementSolver],
                 t_slice_ns: float, n_points: int,
                 static_window: str = "t_constraint",
                 variant_keys=None) -> list:
        """Build-or-fetch LUTs for a batch of substrate variants.

        Cache hits are served per variant; with a batched dp solver
        every *miss* is stacked on the fused lut_pipeline op's variant
        axis and solved in ONE device pass
        (:func:`repro_torch.core.placement.build_lut_grid`) - the DVFS clock
        grid path (DESIGN.md SS.10). Other solvers fall back to one
        :meth:`lut` call per miss. Results keep ``ems`` order.
        """
        sol = make_solver(solver, device=self.device)
        if variant_keys is None:
            variant_keys = [(em.arch.name,) for em in ems]
        ems = list(ems)
        keys = [self.cache_key(
            variant_key=vk, model=em.model, solver_name=sol.name,
            t_slice_ns=t_slice_ns, n_points=n_points, rho=em.rho,
            static_window=static_window,
            slowdown=slowdown_signature(em.time_scale))
            for em, vk in zip(ems, variant_keys)]
        luts = [self._cache.get(k) for k in keys]
        for lut in luts:
            if lut is not None:
                self.n_hits += 1
                obs.metrics().counter("compiler.lut.hit")
        missing = [i for i, lut in enumerate(luts) if lut is None]
        fusable = (isinstance(sol, LUTMethodSolver) and sol.method == "dp"
                   and sol.batched)
        if missing and fusable:
            miss = [ems[i] for i in missing]
            with obs.span("compiler.lut_build", "compiler",
                          variant="grid", model=miss[0].model.name,
                          solver=sol.name, n_points=n_points,
                          n_variants=len(miss)) as sp_:
                built = build_lut_grid(
                    miss, t_slice_ns=t_slice_ns, n_points=n_points,
                    static_window=static_window, device=sol.device)
                sp_.set("backend",
                        getattr(built[0], "backend", None) or "host")
            for i, lut in zip(missing, built):
                self._record_build(lut)
                self._cache[keys[i]] = lut
                luts[i] = lut
        elif missing:
            for i in missing:
                luts[i] = self.lut(
                    ems[i], solver=sol, t_slice_ns=t_slice_ns,
                    n_points=n_points, static_window=static_window,
                    variant_key=variant_keys[i])
        return luts

    # -- fleet bring-up -----------------------------------------------------
    def compile(self, substrates: Iterable, workload=None, *,
                solver=None, t_slice_ns: Optional[float] = None,
                n_points: Optional[int] = None,
                rho: Optional[float] = None
                ) -> Dict[tuple, PlacementLUT]:
        """Batch-build LUTs for every distinct engine shape in one pass.

        ``substrates`` are (possibly repeated) engine variants; shapes
        are deduplicated on ``variant_key()`` before any build, so N
        engines of S distinct shapes cost S builds (or fewer, on cache
        hits from an earlier fleet). Returns ``{variant_key: lut}``.
        """
        out: Dict[tuple, PlacementLUT] = {}
        for sub in substrates:
            vk = sub.variant_key()
            if vk in out:
                continue
            model = sub.model_spec(workload)
            r = sub.rho if rho is None else rho
            em = sub.energy_model(model, rho=r)
            out[vk] = self.lut(
                em, solver=solver or sub.solver,
                t_slice_ns=(sub.default_t_slice_ns(model, rho=r)
                            if t_slice_ns is None else t_slice_ns),
                n_points=(sub.lut_points if n_points is None else n_points),
                static_window=sub.static_window, variant_key=vk)
        return out

    def compile_clock_grid(self, sub, workload=None, *,
                           clocks: Optional[Iterable[float]] = None,
                           n_clocks: int = 5, solver=None,
                           t_slice_ns: Optional[float] = None,
                           n_points: Optional[int] = None,
                           rho: Optional[float] = None
                           ) -> Dict[float, PlacementLUT]:
        """Batch-build one LUT per DVFS clock point of ``sub``'s
        TechModel grid (DESIGN.md SS.10). Returns ``{clock: lut}``.

        Each grid point is ``sub.with_clock(c)`` - a distinct
        ``variant_key()`` - so points dedupe fleet-wide exactly like
        engine shapes: N controllers on the same grid pay one build per
        point; with a batched dp solver all missing points are solved in
        ONE fused lut_pipeline pass (:meth:`lut_grid`). ``clocks=None``
        takes ``n_clocks`` evenly spaced points over the TechModel's
        DVFS bounds plus the substrate's default clock (the legacy
        static operating point stays on the grid)."""
        tm = sub.tech_model()
        if tm is None:
            raise ValueError(
                f"substrate {sub.name!r} has no registered TechModel; "
                f"no clock grid to compile")
        if clocks is None:
            default = getattr(sub, "lp_clock", None)
            include = () if default is None else (default,)
            clocks = tm.clock_grid(n_clocks, include=include)
        model = sub.model_spec(workload)
        r = sub.rho if rho is None else rho
        if t_slice_ns is None:
            t_slice_ns = sub.default_t_slice_ns(model, rho=r)
        clocks = list(clocks)
        variants = [sub.with_clock(c) for c in clocks]
        ems = [EnergyModel(v.arch, model, rho=r) for v in variants]
        luts = self.lut_grid(
            ems, solver=solver or sub.solver, t_slice_ns=t_slice_ns,
            n_points=(sub.lut_points if n_points is None else n_points),
            static_window=sub.static_window,
            variant_keys=[v.variant_key() for v in variants])
        return dict(zip(clocks, luts))

    # -- warm start ---------------------------------------------------------
    # Fleet restarts shouldn't pay bring-up compiles again: save() the
    # cache next to the checkpoints, load() it into the next process'
    # compiler, and every unchanged (variant, model, solver, slice,
    # slowdown) key becomes a cache hit. JSON keeps the bytes exact:
    # Python's float repr round-trips (including +-inf), so a reloaded
    # LUT compares equal (==) to the one that was built.

    def save(self, path) -> Path:
        """Serialize the LUT cache to ``path`` (atomic tmp+rename)."""
        with obs.span("compiler.save", "compiler", entries=len(self._cache)):
            return self._save(path)

    def _save(self, path) -> Path:
        path = Path(path)
        payload = {"version": CACHE_FORMAT_VERSION, "luts": []}
        for key, lut in self._cache.items():
            payload["luts"].append({
                "key": _key_to_jsonable(key),
                "arch": lut.arch_name, "model": lut.model_name,
                "entries": [dataclasses.asdict(e) for e in lut.entries]})
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(payload))
        os.replace(tmp, path)                # atomic on POSIX
        return path

    def load(self, path) -> int:
        """Merge a :meth:`save`d cache; existing keys win. Returns the
        number of LUTs added; a missing file is a cold start (0), a
        version mismatch is skipped rather than raised."""
        with obs.span("compiler.load", "compiler") as sp_:
            added = self._load(path)
            sp_.set("added", added)
            return added

    def _load(self, path) -> int:
        path = Path(path)
        if not path.exists():
            return 0
        payload = json.loads(path.read_text())
        if payload.get("version") != CACHE_FORMAT_VERSION:
            return 0
        added = 0
        for rec in payload["luts"]:
            key = _key_from_jsonable(rec["key"])
            if key in self._cache:
                continue
            entries = [LUTEntry(**e) for e in rec["entries"]]
            self._cache[key] = PlacementLUT(rec["arch"], rec["model"],
                                            entries)
            added += 1
        self.n_loaded += added
        # mirrored like build/hit traffic: warm-started entries are what
        # let autoscaler scale-ups report 0 builds (DESIGN.md SS.9)
        if added:
            obs.metrics().counter("compiler.lut.loaded", added)
        return added

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._cache)

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._cache), "builds": self.n_builds,
                "hits": self.n_hits, "loaded": self.n_loaded,
                "builds_by_backend": dict(self.n_builds_by_backend)}
