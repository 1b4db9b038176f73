"""Straggler detection for the training loop (DESIGN.md §4) — a copy of
``repro.dist.watchdog`` (pure Python), kept here so the port never imports
the JAX package.

``StepWatchdog`` wraps each step in start()/stop() and keeps an EWMA of the
step time. A step slower than ``threshold`` x EWMA (once ``grace_steps``
warm-up steps have completed — the first steps include compilation) fires
``on_straggler`` and is recorded in ``.events``; straggler samples are NOT
folded into the EWMA so one slow host cannot drag the baseline up and mask
the next one, and warm-up samples fold clamped to threshold x EWMA for the
same reason.

``metrics()`` exposes the detector state as a flat per-step metrics dict
(step time, EWMA, straggler flag/total) — the train loop
(``train/loop.py``) records it every step, so a slow step shows up in
the run's metric stream, not just on stderr. Tests drive it through the
injectable ``clock``, never through sleeps.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["StepWatchdog"]


class StepWatchdog:
    """Per-step wall-clock straggler detector.

    threshold:    multiple of the EWMA above which a step is a straggler.
    grace_steps:  completed steps before detection arms (compile warm-up).
    alpha:        EWMA smoothing factor (weight of the newest sample).
    on_straggler: callback (step, dt_seconds, ewma_seconds).
    clock:        injectable time source (tests); defaults to time.monotonic.
    """

    def __init__(self, threshold: float = 3.0, grace_steps: int = 5,
                 alpha: float = 0.25,
                 on_straggler: Optional[Callable[[int, float, float],
                                                 None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = float(threshold)
        self.grace_steps = int(grace_steps)
        self.alpha = float(alpha)
        self.on_straggler = on_straggler
        self.clock = clock
        self.events: List[Tuple[int, float, float]] = []
        self.ewma: Optional[float] = None
        self._n = 0
        self._t0: Optional[float] = None
        self._last_step: Optional[int] = None
        self._last_dt: Optional[float] = None
        self._last_straggler = False

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self, step: int) -> float:
        """End timing for `step`; returns the step duration in seconds."""
        if self._t0 is None:
            raise RuntimeError("StepWatchdog.stop() without start()")
        dt = self.clock() - self._t0
        self._t0 = None
        self._last_step = int(step)
        self._last_dt = float(dt)
        self._last_straggler = False
        armed = self.ewma is not None and self._n >= self.grace_steps
        if armed and dt > self.threshold * self.ewma:
            self._last_straggler = True
            self.events.append((int(step), float(dt), float(self.ewma)))
            if self.on_straggler is not None:
                self.on_straggler(step, dt, self.ewma)
        elif self.ewma is None:
            self.ewma = dt
        else:
            # unarmed spikes fold clamped so warm-up stragglers cannot
            # inflate the baseline past the detection threshold
            dt_c = min(dt, self.threshold * self.ewma)
            self.ewma = (1.0 - self.alpha) * self.ewma + self.alpha * dt_c
        self._n += 1
        return dt

    def metrics(self) -> Dict[str, float]:
        """Detector state as a flat per-step metrics dict.

        Call after :meth:`stop`; the snapshot describes the step just
        stopped. Keys: ``step`` (int), ``step_time_s``,
        ``step_time_ewma_s`` (0.0 until the first sample folds),
        ``straggler`` (1.0 iff the step just stopped fired the detector
        — straggler steps do NOT fold into the EWMA, so the baseline the
        flag was judged against is the one reported), and
        ``straggler_events_total`` (cumulative count, == len(events)).
        """
        return {
            "step": float(-1 if self._last_step is None
                          else self._last_step),
            "step_time_s": float(self._last_dt or 0.0),
            "step_time_ewma_s": float(self.ewma or 0.0),
            "straggler": 1.0 if self._last_straggler else 0.0,
            "straggler_events_total": float(len(self.events)),
        }
