"""Deterministic fault injection + graceful degradation for the serve engine
(copy of ``repro.serve.resilience``).

Three cooperating pieces:

* :class:`FaultInjector` — a **seeded, schedule-driven fault seam**. A
  schedule is a list of :class:`FaultSpec` entries keyed by (site, step,
  slot); at named sites in ``engine.py`` / ``cache.py`` / ``server.py``
  the injector either poisons per-slot logits (NaN/Inf), raises an
  :class:`InjectedFault` (engine-step exception, server error, artifact
  corruption), withholds free pages (pool exhaustion *pressure* — never a
  mid-allocation failure, so cache bookkeeping stays exact), or sleeps
  (slow step). Everything is a pure function of the schedule and the step
  counter: the same schedule replays the same faults, which is what makes
  the chaos tests able to assert byte-identical recovery.

* :class:`DegradationLadder` — a 4-stage ladder with **hysteresis**:
  ``normal -> no_spec -> flush_prefix -> shed_batch``. Pressure must stay
  above ``enter`` for ``up_steps`` consecutive steps to climb one stage,
  and below ``exit`` for ``down_steps`` to descend — the dead band between
  the thresholds prevents flapping at the boundary. Every transition is
  recorded (step, from, to) and surfaced through a callback so the engine
  can log/count it.

* :class:`Resilience` — the per-engine bundle: injector (optional), ladder,
  an EWMA step-time monitor (reusing :class:`repro_torch.dist.straggler.
  StragglerMonitor`), the fault-rate EWMA that feeds ladder pressure, and
  the bounded-retry policy (exponential backoff in *steps* with seeded
  jitter — safe to retry because greedy/seeded decode is deterministic).

The quarantine/retry machinery itself lives in ``engine.py``; this module
only decides *when* faults fire and *how hard* the system should back off.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..dist.straggler import StragglerMonitor

# Named injection sites. Each is checked by exactly one caller:
#   decode_logits  engine: added to target logits before sampling/verify
#   draft_logits   engine: added to draft logits before proposal sampling
#   engine_step    engine: raises just before the decode dispatch
#   slow_step      engine: sleeps at the top of step()
#   pool_exhaust   cache:  PagedCache.available() reports withheld pages
#   artifact_load  checkpoint: flips bytes in the packed artifact on disk
#   server_error   server: the /v1/generate handler returns a structured 500
SITES = ("decode_logits", "draft_logits", "engine_step", "slow_step",
         "pool_exhaust", "artifact_load", "server_error")


class InjectedFault(RuntimeError):
    """Raised by the injector at exception sites. Carries the site name so
    handlers can distinguish injected faults from organic ones."""

    def __init__(self, site: str, step: int):
        super().__init__(f"injected fault at site={site} step={step}")
        self.site = site
        self.step = step


@dataclasses.dataclass
class FaultSpec:
    """One schedule entry: fire ``site`` for steps in
    ``[step, step + n_steps)``, optionally targeting one slot."""
    site: str
    step: int = 0
    n_steps: int = 1
    slot: Optional[int] = None        # logit sites: which batch row
    value: float = float("nan")       # logit sites: poison (nan or +/-inf)
    duration_s: float = 0.02          # slow_step: sleep per step
    n_pages: Optional[int] = None     # pool_exhaust: pages withheld (None=all)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(choose from {SITES})")
        if self.n_steps < 1:
            raise ValueError("n_steps must be >= 1")

    def active(self, step: int) -> bool:
        return self.step <= step < self.step + self.n_steps


class FaultInjector:
    """Schedule-driven fault seam. Holds per-site injection counters and an
    ``on_inject(site)`` callback (wired to ServeMetrics by the engine).
    ``step`` is stamped by the engine at the top of every step so sites
    that cannot receive it as an argument (the cache) still key off the
    same clock."""

    def __init__(self, schedule: Sequence[FaultSpec], seed: int = 0):
        self.schedule: List[FaultSpec] = list(schedule)
        self.seed = seed
        self.step = 0
        self.counts = {s: 0 for s in SITES}
        self.on_inject: Optional[Callable[[str], None]] = None
        # injection counts are a pure function of the schedule: a site may
        # be *consulted* many times per step (e.g. ``withheld_pages`` from
        # every admission probe), but each (site, spec, step) fires once
        self._fired: set = set()

    def _fire(self, site: str, spec_idx: int, step: int) -> None:
        key = (site, spec_idx, step)
        if key in self._fired:
            return
        self._fired.add(key)
        self.counts[site] += 1
        if self.on_inject is not None:
            self.on_inject(site)

    @property
    def total_injected(self) -> int:
        return sum(self.counts.values())

    # ------------------------------------------------------------- per site
    def poison(self, site: str, step: int, n_slots: int) -> Optional[np.ndarray]:
        """(n_slots,) float32 additive poison for logit sites, or None when
        nothing is scheduled this step (callers then pass a cached zeros
        vector — one compiled program either way)."""
        vec = None
        for i, spec in enumerate(self.schedule):
            if spec.site != site or not spec.active(step):
                continue
            if spec.slot is None or spec.slot >= n_slots:
                continue
            if vec is None:
                vec = np.zeros((n_slots,), np.float32)
            vec[spec.slot] = spec.value
            self._fire(site, i, step)
        return vec

    def check(self, site: str, step: Optional[int] = None) -> None:
        """Raise :class:`InjectedFault` if an exception-site entry is
        active. Used for engine_step / server_error / artifact_load."""
        step = self.step if step is None else step
        for i, spec in enumerate(self.schedule):
            if spec.site == site and spec.active(step):
                self._fire(site, i, step)
                raise InjectedFault(site, step)

    def slow(self, step: int) -> float:
        """Total scheduled sleep for this step (0.0 = no slow fault)."""
        total = 0.0
        for i, spec in enumerate(self.schedule):
            if spec.site == "slow_step" and spec.active(step):
                total += spec.duration_s
                self._fire("slow_step", i, step)
        return total

    def withheld_pages(self, step: Optional[int] = None) -> int:
        """Pages the pool must pretend it doesn't have (pool_exhaust).
        ``n_pages=None`` withholds everything. Read by
        ``PagedCache.available()``; injection is *pressure*, never a
        failed allocation, so allocator bookkeeping stays exact."""
        step = self.step if step is None else step
        held = 0
        for i, spec in enumerate(self.schedule):
            if spec.site == "pool_exhaust" and spec.active(step):
                held = max(held, spec.n_pages if spec.n_pages is not None
                           else 1 << 30)
                self._fire("pool_exhaust", i, step)
        return held

    def corrupt_artifact(self, packed_dir) -> Optional[str]:
        """artifact_load site: flip one seeded byte in the packed shard so
        the next ``load_packed`` fails the manifest checksum. Returns the
        corrupted path (None if no shard found)."""
        import pathlib
        d = pathlib.Path(packed_dir)
        shards = sorted(d.glob("*.npz")) or sorted(d.glob("shard*"))
        if not shards:
            return None
        path = shards[0]
        raw = bytearray(path.read_bytes())
        rng = np.random.default_rng(self.seed)
        # corrupt inside the payload, clear of the zip header
        i = int(rng.integers(len(raw) // 2, len(raw)))
        raw[i] ^= 0xFF
        path.write_bytes(bytes(raw))
        self._fire("artifact_load", -1, self.step)
        return str(path)


# ------------------------------------------------------------ builtin storms

def storm_schedule() -> List[FaultSpec]:
    """The builtin recoverable chaos storm used by CI: NaN logits on two
    slots, one engine-step exception, a slow step, and a pool-exhaustion
    window — all early enough to land while a smoke workload is in flight,
    all survivable within the default retry budget."""
    return [
        FaultSpec("decode_logits", step=3, slot=0),
        FaultSpec("decode_logits", step=9, slot=1,
                  value=float("inf")),
        FaultSpec("engine_step", step=5),
        FaultSpec("slow_step", step=6, duration_s=0.01),
        FaultSpec("pool_exhaust", step=11, n_steps=3),
    ]


BUILTIN_SCHEDULES = {"storm": storm_schedule}


def parse_schedule(text: str) -> List[FaultSpec]:
    """``--chaos-schedule`` parser: a builtin name (``storm``), a JSON list
    of FaultSpec dicts, or ``@path`` to a JSON file."""
    if text in BUILTIN_SCHEDULES:
        return BUILTIN_SCHEDULES[text]()
    if text.startswith("@"):
        with open(text[1:]) as f:
            raw = json.load(f)
    else:
        raw = json.loads(text)
    if not isinstance(raw, list):
        raise ValueError("chaos schedule must be a JSON list of fault specs")
    return [FaultSpec(**e) for e in raw]


# -------------------------------------------------------- degradation ladder

STAGE_NAMES = ("normal", "no_spec", "flush_prefix", "shed_batch")


class DegradationLadder:
    """Hysteresis ladder over a scalar pressure signal in [0, 1].

    Climb one stage after ``up_steps`` *consecutive* observations at or
    above ``enter``; descend one stage after ``down_steps`` consecutive
    observations at or below ``exit``. Observations in the dead band
    ``(exit, enter)`` reset both streaks — the current stage holds. This
    makes every transition deliberate: a single pressure spike (or a
    single relieved step) never toggles a stage.

    ``force(stage)`` pins the ladder (benchmarks measure a degraded stage
    without having to synthesize pressure); ``force(None)`` releases it.
    """

    N_STAGES = len(STAGE_NAMES)

    def __init__(self, enter: float = 0.92, exit: float = 0.60,
                 up_steps: int = 3, down_steps: int = 10):
        if not (0.0 <= exit < enter <= 1.0):
            raise ValueError(f"need 0 <= exit < enter <= 1, "
                             f"got exit={exit} enter={enter}")
        self.enter, self.exit = enter, exit
        self.up_steps, self.down_steps = up_steps, down_steps
        self.stage = 0
        self.max_stage = 0
        self.transitions: List[Tuple[int, int, int]] = []  # (step, old, new)
        self.on_transition: Optional[Callable[[int, int], None]] = None
        self._up = 0
        self._dn = 0
        self._forced: Optional[int] = None

    def force(self, stage: Optional[int]) -> None:
        if stage is not None and not (0 <= stage < self.N_STAGES):
            raise ValueError(f"stage must be in [0, {self.N_STAGES})")
        if stage is not None and stage != self.stage:
            self._move(stage, step=-1)
        self._forced = stage

    def _move(self, new: int, step: int) -> None:
        old, self.stage = self.stage, new
        self.max_stage = max(self.max_stage, new)
        self.transitions.append((step, old, new))
        if self.on_transition is not None:
            self.on_transition(old, new)

    def observe(self, pressure: float, step: int = 0) -> int:
        if self._forced is not None:
            return self.stage
        if pressure >= self.enter:
            self._up += 1
            self._dn = 0
        elif pressure <= self.exit:
            self._dn += 1
            self._up = 0
        else:                       # dead band: hold, reset both streaks
            self._up = self._dn = 0
        if self._up >= self.up_steps and self.stage < self.N_STAGES - 1:
            self._up = 0
            self._move(self.stage + 1, step)
        elif self._dn >= self.down_steps and self.stage > 0:
            self._dn = 0
            self._move(self.stage - 1, step)
        return self.stage

    # ----------------------------------------------------- stage predicates
    @property
    def spec_disabled(self) -> bool:
        return self.stage >= 1

    @property
    def flush_prefix(self) -> bool:
        return self.stage >= 2

    @property
    def shed_batch(self) -> bool:
        return self.stage >= 3

    @property
    def stage_name(self) -> str:
        return STAGE_NAMES[self.stage]


# ------------------------------------------------------------------- bundle

class Resilience:
    """Per-engine resilience bundle: injector + ladder + step-time monitor +
    retry policy. The engine owns calling :meth:`begin_step` /
    :meth:`end_step` and consults :meth:`backoff_steps` when it quarantines
    a slot.

    ``ladder=None`` (the default) runs without a degradation ladder: the
    watchdog (quarantine + bounded retry) is pure-win and always on, but
    the ladder changes serving *policy* (spec off, trie flush, shedding),
    so it is opt-in per deployment — ``launch.serve`` wires one in; bare
    engines in unit tests keep today's behavior exactly."""

    def __init__(self, injector: Optional[FaultInjector] = None,
                 ladder: Optional[DegradationLadder] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 max_fault_retries: int = 2,
                 retry_backoff_steps: int = 2,
                 max_consecutive_step_faults: int = 8,
                 fault_ewma_alpha: float = 0.25,
                 seed: int = 0):
        self.injector = injector
        self.ladder = ladder
        self.monitor = monitor if monitor is not None else \
            StragglerMonitor(warmup_steps=8, sigma_threshold=4.0)
        self.max_fault_retries = max_fault_retries
        self.retry_backoff_steps = retry_backoff_steps
        self.max_consecutive_step_faults = max_consecutive_step_faults
        self.fault_ewma_alpha = fault_ewma_alpha
        self.seed = seed
        self.fault_ewma = 0.0           # faults-per-step, EWMA
        self.n_slow_flags = 0           # step-time monitor escalations
        self.consecutive_step_faults = 0
        self._step_had_fault = False

    # --------------------------------------------------------- step bracket
    def begin_step(self, step: int) -> None:
        self._step_had_fault = False
        if self.injector is not None:
            self.injector.step = step
            dt = self.injector.slow(step)
            if dt > 0:
                time.sleep(dt)

    def end_step(self, wall_dt: float) -> str:
        """Feed the EWMA step-time monitor and decay the fault EWMA.
        Returns the monitor verdict ("ok" / "flag" / "checkpoint")."""
        a = self.fault_ewma_alpha
        self.fault_ewma = a * float(self._step_had_fault) + \
            (1.0 - a) * self.fault_ewma
        verdict = self.monitor.observe(wall_dt)
        if verdict != "ok":
            self.n_slow_flags += 1
        return verdict

    def note_fault(self) -> None:
        """Any fault this step (quarantine or caught step exception) —
        feeds the fault-rate half of ladder pressure."""
        self._step_had_fault = True

    # -------------------------------------------------------------- signals
    def pressure(self, pool_utilization: float) -> float:
        """Ladder input: worst of page pressure and fault-storm pressure.
        A sustained fault every other step saturates to 1.0."""
        fault_pressure = min(1.0, 2.0 * self.fault_ewma)
        return max(float(pool_utilization), fault_pressure)

    def backoff_steps(self, req_id: int, n_retries: int) -> int:
        """Steps to wait before re-admitting a quarantined request:
        exponential in the retry count with seeded jitter — deterministic
        for a given (seed, request, attempt), so chaos runs replay."""
        base = self.retry_backoff_steps * (2 ** max(0, n_retries - 1))
        rng = np.random.default_rng((self.seed, int(req_id), int(n_retries)))
        return base + int(rng.integers(0, self.retry_backoff_steps + 1))

    def summary(self) -> dict:
        out = {
            "fault_ewma": round(self.fault_ewma, 4),
            "n_slow_flags": self.n_slow_flags,
        }
        if self.ladder is not None:
            out.update(degradation_stage=self.ladder.stage,
                       degradation_max_stage=self.ladder.max_stage,
                       degradation_transitions=len(self.ladder.transitions))
        if self.injector is not None:
            out["faults_injected"] = {k: v for k, v in
                                      self.injector.counts.items() if v}
        return out
