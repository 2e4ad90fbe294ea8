"""Process-local Counter/Gauge/Histogram registry + text exposition.

One namespaced scheme (``dtg_<area>_<what>[_total]``) absorbing the
counters that today live on scattered objects: engine ``health()``,
block-pool occupancy/refcounts, prefix-index size, per-tenant DRR stats,
dispatch/prefetch host-gap accounting, train-loop step/ckpt/anomaly
counts. ``snapshot()`` gives a flat dict (histograms as
``{count, sum, buckets}``), :meth:`Registry.to_prometheus` the
Prometheus text exposition format.

Strictly passive: absorbing reads host-side numbers that already exist;
nothing here is consulted by any scheduler or compiled program.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable

#: default histogram buckets: exponential, micro-seconds to minutes —
#: wide enough for step times and launch latencies alike.
DEFAULT_BUCKETS = tuple(1e-6 * 4 ** i for i in range(14))


def _label_str(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing; ``set_total`` absorbs an externally
    maintained cumulative count (engine health counters)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None):
        self.name, self.help, self.labels = name, help, labels or {}
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += n

    def set_total(self, v: float) -> None:
        self.value = float(v)


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None):
        self.name, self.help, self.labels = name, help, labels or {}
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.name, self.help, self.labels = name, help, labels or {}
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def snapshot_value(self) -> dict:
        cum, out = 0, {}
        for le, c in zip(self.buckets, self.counts):
            cum += c
            out[le] = cum
        return {"count": self.count, "sum": self.sum, "buckets": out}


class Registry:
    """Get-or-create metric registry, keyed (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}

    def _get(self, cls, name: str, help: str, labels: dict | None,
             **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"{name} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def snapshot(self) -> dict:
        """Flat dict: ``name{label="v"}`` -> scalar, histograms ->
        ``{count, sum, buckets}``."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        for m in metrics:
            key = m.name + _label_str(m.labels)
            out[key] = (m.snapshot_value() if isinstance(m, Histogram)
                        else m.value)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (one HELP/TYPE block per family)."""
        with self._lock:
            metrics = list(self._metrics.values())
        seen_family: set[str] = set()
        lines: list[str] = []
        for m in sorted(metrics, key=lambda m: (m.name,
                                                _label_str(m.labels))):
            if m.name not in seen_family:
                seen_family.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            ls = _label_str(m.labels)
            if isinstance(m, Histogram):
                cum = 0
                for le, c in zip(m.buckets, m.counts):
                    cum += c
                    lab = dict(m.labels)
                    lab["le"] = f"{le:g}"
                    lines.append(
                        f"{m.name}_bucket{_label_str(lab)} {cum}")
                lab = dict(m.labels)
                lab["le"] = "+Inf"
                lines.append(
                    f"{m.name}_bucket{_label_str(lab)} {m.count}")
                lines.append(f"{m.name}_sum{ls} {m.sum:g}")
                lines.append(f"{m.name}_count{ls} {m.count}")
            else:
                v = m.value if math.isfinite(m.value) else float("nan")
                lines.append(f"{m.name}{ls} {v:g}")
        return "\n".join(lines) + "\n"


# ---- absorbers: existing host-side stats -> the one namespace -------------


def absorb_engine(reg: Registry, health: dict) -> None:
    """``ServeEngine.health()`` -> ``dtg_serve_*`` metrics (gauges for
    instantaneous occupancy, counters for cumulative event counts,
    per-tenant DRR stats as labeled counters)."""
    for k in ("resident", "queued", "live_blocks", "prefix_nodes"):
        if k in health:
            reg.gauge(f"dtg_serve_{k}").set(health[k])
    # host spill tier: instantaneous occupancy of the host
    # BlockStore under the device pool
    for k in ("host_blocks", "host_bytes"):
        if k in health:
            reg.gauge(f"dtg_serve_spill_{k}").set(health[k])
    if "last_tick_s" in health:
        reg.gauge("dtg_serve_last_tick_s").set(health["last_tick_s"])
    for k in ("completed", "shed", "cancelled", "expired", "preemptions",
              "prefix_hit_tokens", "prefill_tokens_saved",
              "prefix_evictions", "spill_out_blocks", "spill_in_blocks",
              "spill_d2h_bytes", "spill_h2d_bytes",
              "spill_prefetched_blocks", "spill_resumes",
              "swapin_tokens_saved", "launch_failures"):
        if k in health:
            reg.counter(f"dtg_serve_{k}_total").set_total(health[k])
    if "ticks" in health:
        reg.counter("dtg_serve_ticks_total").set_total(health["ticks"])
    for tenant, c in (health.get("tenants") or {}).items():
        for k, v in c.items():
            reg.counter(f"dtg_serve_tenant_{k}_total",
                        labels={"tenant": str(tenant)}).set_total(v)
    # mixture-of-experts decode: per-expert routed/overflowed token
    # counts as labeled counters, stall ticks as engine-wide counters —
    # the load/overflow skew is THE capacity-tuning signal
    moe = health.get("moe")
    if moe:
        for e, v in enumerate(moe.get("expert_load", ())):
            reg.counter("dtg_moe_expert_load_total",
                        labels={"expert": str(e)}).set_total(v)
        for e, v in enumerate(moe.get("expert_overflow", ())):
            reg.counter("dtg_moe_expert_overflow_total",
                        labels={"expert": str(e)}).set_total(v)
        for k in ("stall_slot_ticks", "stall_ticks"):
            if k in moe:
                reg.counter(f"dtg_moe_{k}_total").set_total(moe[k])


def absorb_fleet(reg: Registry, health: dict) -> None:
    """``FleetScheduler.health()`` -> ``dtg_fleet_*`` metrics: fleet
    counters and the global tenant aggregation at the top level,
    per-replica engine healths re-absorbed through
    :func:`absorb_engine`'s scheme under a ``replica`` label."""
    reg.gauge("dtg_fleet_queued").set(health.get("queued", 0))
    reg.gauge("dtg_fleet_live_replicas").set(
        health.get("live_replicas", 0))
    reg.gauge("dtg_fleet_generation").set(health.get("generation", 0))
    for k in ("shed", "completed", "migrations", "migration_bytes",
              "replicas_shed", "replicas_regrown", "prefix_route_hits",
              "prefix_route_hit_tokens",
              # the reliability plane: crash/stall recoveries, the
              # breaker's eject/probe/recover cycle, step-boundary
              # faults, exactly-once adoption drops, autoscale actions
              "replica_crashes", "replica_stalls", "breaker_ejections",
              "breaker_probes", "breaker_recoveries", "replica_faults",
              "launch_failures", "migration_dups_dropped",
              "autoscale_added", "autoscale_retired"):
        if k in health:
            reg.counter(f"dtg_fleet_{k}_total").set_total(health[k])
    if "migration_secs" in health:
        reg.gauge("dtg_fleet_migration_s").set(health["migration_secs"])
    if "stalled" in health:
        reg.gauge("dtg_fleet_stalled_replicas").set(
            len(health["stalled"]))
    if "draining" in health:
        reg.gauge("dtg_fleet_draining_replicas").set(
            len(health["draining"]))
    autoscale = health.get("autoscale")
    if autoscale:
        reg.gauge("dtg_fleet_autoscale_target").set(
            autoscale.get("target_replicas", 0))
    for tenant, c in (health.get("tenants") or {}).items():
        for k, v in c.items():
            reg.counter(f"dtg_fleet_tenant_{k}_total",
                        labels={"tenant": str(tenant)}).set_total(v)
    for i, h in enumerate(health.get("replicas") or []):
        labels = {"replica": str(i), "role": str(h.get("role", ""))}
        reg.gauge("dtg_fleet_replica_live", labels=labels).set(
            1.0 if h.get("live") else 0.0)
        br = h.get("breaker")
        if br:
            reg.gauge("dtg_fleet_replica_breaker_open",
                      labels=labels).set(
                0.0 if br.get("state") == "closed" else 1.0)
        for k in ("resident", "queued", "live_blocks"):
            if k in h:
                reg.gauge(f"dtg_fleet_replica_{k}",
                          labels=labels).set(h[k])
        for k in ("completed", "shed", "preemptions",
                  "migrated_out", "migrated_in", "launch_failures"):
            if k in h:
                reg.counter(f"dtg_fleet_replica_{k}_total",
                            labels=labels).set_total(h[k])


def absorb_pool(reg: Registry, stats: dict) -> None:
    """``BlockPool.stats()`` -> ``dtg_serve_pool_*`` gauges."""
    for k, v in stats.items():
        reg.gauge(f"dtg_serve_pool_{k}").set(v)


def absorb_prefix(reg: Registry, stats: dict) -> None:
    """``PrefixIndex.stats()`` -> ``dtg_serve_prefix_*`` gauges."""
    for k, v in stats.items():
        reg.gauge(f"dtg_serve_prefix_{k}").set(v)


def absorb_spill_store(reg: Registry, stats: dict) -> None:
    """``BlockStore.stats()`` -> ``dtg_serve_spill_store_*`` gauges."""
    for k, v in stats.items():
        reg.gauge(f"dtg_serve_spill_store_{k}").set(v)


def absorb_dispatch(reg: Registry, stats) -> None:
    """``utils.profiling.DispatchStats`` -> ``dtg_train_*`` — the
    host-gap numbers that were only reachable by attribute-poking."""
    reg.counter("dtg_train_dispatches_total").set_total(stats.dispatches)
    reg.counter("dtg_train_opt_steps_total").set_total(stats.steps)
    reg.gauge("dtg_train_host_gap_s").set(stats.host_gap_s)
    reg.gauge("dtg_train_dispatch_enqueue_s").set(stats.dispatch_s)
    if stats.dispatches:
        reg.gauge("dtg_train_host_gap_ms_per_dispatch").set(
            1e3 * stats.host_gap_s / stats.dispatches)


def absorb_prefetch(reg: Registry, stats) -> None:
    """``data.prefetch.PrefetchStats`` -> ``dtg_data_prefetch_*``."""
    reg.counter("dtg_data_prefetch_batches_total").set_total(stats.batches)
    reg.gauge("dtg_data_prefetch_host_wait_s").set(stats.host_wait_s)
    reg.gauge("dtg_data_prefetch_max_host_wait_s").set(
        stats.max_host_wait_s)
    reg.gauge("dtg_data_prefetch_put_s").set(stats.put_s)
    reg.gauge("dtg_data_prefetch_peak_ahead").set(stats.peak_ahead)
