"""The online adaptation loop: predict -> serve -> label -> retrain ->
hot-swap, closed (the port of ``repro.online.controller``).

``OnlineController`` wires the subsystem together around a live
``RetrievalService`` + ``RetrievalServer``:

    serving path      telemetry ring        idle capacity
    ────────────      ──────────────        ─────────────
    service ──tap──►  TelemetryBuffer ──►  ShadowExecutor (full-fidelity
       ▲                                    re-runs + MED labels)
       │                                        │
       │   PredictorStore.install (atomic      ├──► EnvelopeMonitor
       └── hot-swap, same table shapes)        │    (tau / fallback)
                 ▲                             ▼
                 └── publish ──── CascadeTrainer (sliding-window refits)

``step()`` runs one full cycle inline (deterministic — tests, benchmarks
and the example drive it directly).  ``start()`` runs the same cycle on
a background daemon thread gated on service idleness
(``service.outstanding == 0``), so shadow re-execution and retraining
consume idle capacity rather than competing with live traffic.  Every
store, trainer and the shadow run on the server's device; the store
fences each publish, so the service's predict stream never reads a
table still being written.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from repro_torch.obs import NULL_OBS
from repro_torch.online.drift import DriftConfig, EnvelopeMonitor
from repro_torch.online.shadow import ShadowExecutor
from repro_torch.online.store import PredictorStore
from repro_torch.online.telemetry import TelemetryBuffer
from repro_torch.online.trainer import CascadeTrainer, TrainerConfig

__all__ = ["OnlineConfig", "OnlineController"]


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    tau: float = 0.05              # envelope target (drift monitor owns
    #                                the labeling tau it hands retrains)
    shadow_sample: int = 64        # logged queries labeled per cycle
    shadow_period_s: float = 0.02  # background pacing between cycles
    idle_only: bool = True         # gate background cycles on idleness
    importance: bool = False       # margin-based shadow sample selection
    pool_factor: int = 4           # oversampling factor for importance
    trainer: TrainerConfig = dataclasses.field(
        default_factory=TrainerConfig)
    drift: DriftConfig | None = None   # default: DriftConfig(target=tau)
    metric: str = "rbp"
    rbp_p: float = 0.95
    seed: int = 0


class OnlineController:
    """Owns the shadow/train/swap cycle for one service."""

    def __init__(self, service, server, cfg: OnlineConfig | None = None):
        self.cfg = cfg or OnlineConfig()
        self.service = service
        self.server = server
        if service.telemetry is None:
            service.telemetry = TelemetryBuffer()
        self.telemetry = service.telemetry
        self.shadow = ShadowExecutor(
            server, self.telemetry, sample=self.cfg.shadow_sample,
            metric=self.cfg.metric, rbp_p=self.cfg.rbp_p,
            seed=self.cfg.seed, importance=self.cfg.importance,
            pool_factor=self.cfg.pool_factor)
        if server.cascade is None:
            raise ValueError(
                "OnlineController needs a server built with a trained "
                "cascade (the boot predictor is the swap template)")
        # per-knob adaptation state: the registry's knobs each get their
        # own trainer / versioned store / drift monitor, all fed from the
        # *same* shadow batch (one reference run labels every knob).  The
        # primary knob (cfg.knob) is aliased as .trainer/.store/.monitor
        # for back-compat; a "depth" entry exists iff the server was
        # booted with a depth cascade (the swap template for that knob).
        primary = server.cfg.knob
        drift = self.cfg.drift or DriftConfig(target=self.cfg.tau)
        boot_thr = [server.cfg.threshold] * server.cascade.n_cutoffs
        dev = server.device
        self.trainers = {primary: CascadeTrainer(
            self.cfg.trainer, server.cfg.cutoffs, device=dev)}
        self.stores = {primary: PredictorStore(server.cascade, boot_thr,
                                               device=dev)}
        self.monitors = {primary: EnvelopeMonitor(drift)}
        if server.depth_cascade is not None:
            self.trainers["depth"] = CascadeTrainer(
                self.cfg.trainer, server.cfg.depth_cutoffs, device=dev)
            dthr = [server.cfg.threshold] * len(server.cfg.depth_cutoffs)
            self.stores["depth"] = PredictorStore(
                server.depth_cascade, dthr, device=dev)
            self.monitors["depth"] = EnvelopeMonitor(drift)
        self.trainer = self.trainers[primary]
        self.store = self.stores[primary]
        self.monitor = self.monitors[primary]
        self._primary = primary
        # serve the store's boot versions from the start, so every later
        # swap replaces a table the store keeps alive
        for knob, store in self.stores.items():
            store.install(server, knob=knob)
        self.n_swaps = 0
        self.n_steps = 0
        self.last_error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # share the service's observability handle by default: online
        # spans (shadow / refit / swap / fallback events) land in the
        # same recorder as the serving path's
        self.bind_obs(getattr(service, "obs", NULL_OBS))

    def bind_obs(self, obs) -> None:
        self.obs = obs
        self._m_shadow = obs.metrics.counter("online.shadow_runs")
        self._m_refits = obs.metrics.counter("online.refits")
        self._m_swaps = obs.metrics.counter("online.swaps")
        self._m_fallbacks = obs.metrics.counter("online.fallbacks")

    # -------------------------------------------------------- one cycle --
    def _knob_batch(self, knob: str, batch):
        """The knob's view of a shadow batch: the primary sees it as-is;
        secondary knobs swap in their own MED table / observed column
        from ``med_by_knob`` (or None when the shadow didn't label
        them)."""
        if knob == self._primary:
            return batch
        sub = batch.med_by_knob.get(knob)
        if sub is None:
            return None
        return dataclasses.replace(
            batch, med=sub["med"], observed_med=sub["observed_med"],
            served_class=sub["served_class"])

    def step(self) -> dict:
        """One inline shadow -> label -> (retrain -> swap) cycle, run
        for every knob with adaptation state (same batch, per-knob
        labels)."""
        self.n_steps += 1
        trace = self.obs.trace
        with trace.span("online.shadow", step=self.n_steps):
            batch = self.shadow.run_once()
        if batch is None:
            return self.stats()
        self._m_shadow.inc()
        for knob, trainer in self.trainers.items():
            kb = self._knob_batch(knob, batch)
            if kb is None:
                continue
            decision = self.monitors[knob].observe(kb.observed_med)
            if knob == self._primary:
                # only the primary's monitor trips the global fallback
                # breaker — fallback pins *every* knob to its reference
                # (KnobSpec.params_of), so a depth-only drift must not
                # widen stage 1; the depth monitor just drives the
                # labeling tau of its own retrains
                if decision.fallback and not self.server.fallback:
                    trace.event("online.fallback", step=self.n_steps)
                    self._m_fallbacks.inc()
                self.server.fallback = decision.fallback
            trainer.add(kb)
            if trainer.should_retrain():
                with trace.span("online.refit", knob=knob,
                                tau=round(float(decision.tau), 6)):
                    casc, thresholds = trainer.retrain(decision.tau)
                self._m_refits.inc()
                with trace.span("online.swap", knob=knob):
                    self.stores[knob].publish(
                        casc, thresholds, trained_on=trainer.window_size)
                    self.stores[knob].install(self.server, knob=knob)
                self._m_swaps.inc()
                self.n_swaps += 1
        return self.stats()

    # -------------------------------------------------- background loop --
    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self.cfg.idle_only or self.service.outstanding == 0:
                try:
                    self.step()
                except Exception as e:  # noqa: BLE001 — adaptation must
                    self.last_error = e  # never take the serving path
                    #                      down; stats() surfaces it
            self._stop.wait(self.cfg.shadow_period_s)

    def start(self) -> "OnlineController":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="online-adapt", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 60.0) -> None:
        """Stop the background loop.  The join timeout is generous: a
        cycle mid-shadow holds real engine dispatches, and a daemon
        thread abandoned mid-dispatch aborts interpreter teardown."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def __enter__(self) -> "OnlineController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- stats --
    def stats(self) -> dict:
        knobs = {
            knob: {
                "n_labels": t.n_labels,
                "n_retrains": t.n_retrains,
                "n_published": self.stores[knob].n_published,
                "tau_effective": self.monitors[knob].tau,
                "med_ema": self.monitors[knob].med_ema,
            }
            for knob, t in self.trainers.items()
        }
        return {
            "n_steps": self.n_steps,
            "knobs": knobs,
            "n_labels": self.trainer.n_labels,
            "n_retrains": self.trainer.n_retrains,
            "n_swaps": self.n_swaps,
            "predictor_version": self.server.predictor_version,
            "tau_effective": self.monitor.tau,
            "med_ema": self.monitor.med_ema,
            "fallback": self.monitor.fallback,
            "n_fallbacks": self.monitor.n_fallbacks,
            "telemetry_seen": self.telemetry.n_seen,
            "telemetry_dropped": self.telemetry.n_dropped,
            "last_error": (repr(self.last_error)
                           if self.last_error is not None else None),
            "t_wall": time.perf_counter(),
        }
