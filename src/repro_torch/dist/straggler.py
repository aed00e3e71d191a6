"""Step-time straggler detection with checkpoint escalation (copy of
``repro.dist.straggler``).

At pod scale a single slow host stalls every collective; the symptom at the
train loop is a step-time outlier. :class:`StragglerMonitor` keeps an
exponentially-weighted mean/variance of observed step times and classifies
each step:

* ``"ok"``         — within tolerance (and the statistics absorb it, so slow
  *drift* — thermal throttling, growing batches — never trips the monitor),
* ``"flag"``       — an outlier beyond ``sigma_threshold`` sigmas *and* the
  relative floor; statistics are frozen for the step so one bad host can't
  poison the baseline,
* ``"checkpoint"`` — ``flag_budget`` consecutive outliers: the loop should
  snapshot now, before a likely preemption/failure turns slow into gone.
  Escalation *re-baselines*: the outlier is absorbed and the window counter
  cleared, so a persistent regime shift (legitimately slower steps) converges
  to the new normal instead of requesting a checkpoint every step forever.
  ``flags_total`` stays cumulative across the run for reporting.
"""

from __future__ import annotations

import time
from typing import Optional


class StragglerMonitor:
    def __init__(self, warmup_steps: int = 10, sigma_threshold: float = 3.0,
                 flag_budget: int = 3, ewma_alpha: float = 0.2,
                 rel_floor: float = 0.05):
        self.warmup_steps = warmup_steps
        self.sigma_threshold = sigma_threshold
        self.flag_budget = flag_budget
        self.ewma_alpha = ewma_alpha
        self.rel_floor = rel_floor  # outliers must also exceed mean*(1+floor)
        self.steps = 0
        self.flags_total = 0   # cumulative, for reporting
        self._window = 0       # consecutive outliers; drives escalation
        self._mean = 0.0
        self._var = 0.0
        self._t0: Optional[float] = None

    # --- statistics -------------------------------------------------------
    @property
    def mean_step_time(self) -> float:
        return self._mean

    def _absorb(self, dt: float) -> None:
        if self.steps == 0:
            self._mean, self._var = dt, 0.0
        else:
            a = self.ewma_alpha
            delta = dt - self._mean
            self._mean += a * delta
            self._var = (1 - a) * (self._var + a * delta * delta)
        self.steps += 1

    # --- observation ------------------------------------------------------
    def observe(self, dt: float) -> str:
        """Feed one step time (seconds); returns the verdict for this step."""
        if self.steps < self.warmup_steps:
            self._absorb(dt)
            return "ok"
        sigma = self._var ** 0.5
        threshold = self._mean + max(self.sigma_threshold * sigma,
                                     self.rel_floor * self._mean)
        if dt > threshold:
            self.flags_total += 1
            self._window += 1
            if self._window >= self.flag_budget:
                # escalate once, then re-baseline on the new regime
                self._window = 0
                self._absorb(dt)
                return "checkpoint"
            return "flag"
        self._window = 0
        self._absorb(dt)
        return "ok"

    # --- wall-clock convenience (the train loop's interface) --------------
    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> str:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)
