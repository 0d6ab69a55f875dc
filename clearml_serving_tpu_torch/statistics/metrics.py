"""Statistics controller: broker -> Prometheus collectors.

The port's copy of ``clearml_serving_tpu/statistics/metrics.py``, with the
same metric names and labels (Grafana's dashboards under ``docker/`` read
them):

- consumes the stats topic, lazily creating one Prometheus collector per
  (endpoint, variable), named ``{endpoint}:{variable}`` sanitized;
- reserved variables: ``_latency`` -> histogram with 5 ms-5 s buckets,
  ``_count`` -> counter (weighted by the sampling-unbias factor);
- metric-spec types: scalar -> bucketed Histogram, enum -> EnumHistogram
  over the declared buckets (labeled-Counter fallback when no buckets are
  declared), value -> Gauge, counter -> Counter;
- endpoints it does not know get reserved-only logging and a throttled
  config re-sync;
- the scrape-time collectors of the LLM engines (prefix cache, request
  lifecycle, replica router), registered by ``llm/openai_api.py``. The
  reference's families that nothing in the port produces (the compile and
  sharding sentries', the gRPC client's) are left out.

Device gauges: ``tpu_hbm_bytes_in_use`` / ``tpu_hbm_bytes_limit`` (the
reference's names, label ``device``) read ``torch.cuda.memory_stats()`` and
``torch.cuda.mem_get_info()`` per card, only in a process that already
holds a CUDA context: the statistics service is a process of its own, and
a context made there would hold card memory for nothing.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Dict, Optional

from prometheus_client import Counter, Gauge, Histogram, REGISTRY

from .broker import make_consumer

_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
    1.0, 2.5, 5.0, float("inf"),
)

_name_re = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    return _name_re.sub("_", name)


class EnumHistogram:
    """Enum histogram (the reference's, ``clearml_serving/statistics``).

    Exports a histogram-typed family with one NON-cumulative
    ``{name}_bucket{enum="<value>"}`` series per **declared** enum value (in
    declared order — the bucket set and ordering come from the metric spec,
    not from whichever values happen to arrive first) plus ``{name}_sum`` =
    total observations. Values outside the declared set are dropped, matching
    the reference's fixed-bucket contract. Enum specs below the two-bucket
    minimum fall back to a value-labeled Counter (dynamic value set) — see
    StatisticsController._collector.
    """

    def __init__(self, name: str, documentation: str, buckets, registry=REGISTRY):
        buckets = [str(b) for b in buckets]
        if len(buckets) < 2:
            raise ValueError("enum histogram needs at least two declared buckets")
        self._name = name
        self._documentation = documentation
        self._buckets = {b: 0.0 for b in buckets}  # insertion = declared order
        self._sum = 0.0
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def observe(self, value) -> None:
        v = str(value)
        with self._lock:
            if v not in self._buckets:
                return
            self._buckets[v] += 1.0
            self._sum += 1.0

    def collect(self):
        from prometheus_client.core import Metric

        metric = Metric(self._name, self._documentation, "histogram")
        with self._lock:
            for bucket, acc in self._buckets.items():
                metric.add_sample(
                    self._name + "_bucket", {"enum": bucket}, acc
                )
            metric.add_sample(self._name + "_sum", {}, self._sum)
        return [metric]

    def describe(self):
        return self.collect()



class _KeyedCollector:
    """Shared bookkeeping for scrape-time collectors keyed by model (or
    model@replica): one entry per key, replace-on-reregister (endpoint
    hot-reload must not leak the old engine or duplicate families), and
    hot-reload pruning for per-replica key variants."""

    def __init__(self, prefix: str):
        self._prefix = _sanitize(prefix)
        self._entries: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def set_entry(self, key: str, value) -> None:
        with self._lock:
            self._entries[str(key)] = value

    def remove_entry(self, key: str, only=None) -> None:
        """Drop ``key``'s entry; with ``only``, just while the entry is
        still that object (a prefix-cache entry: while it holds that
        cache)."""
        with self._lock:
            entry = self._entries.get(str(key))
            if only is not None and entry is not only and not (
                    isinstance(entry, tuple) and entry and entry[0] is only):
                return
            self._entries.pop(str(key), None)

    def prune_entries(self, key: str, keep) -> None:
        """Drop entries registered for ``key`` or its per-replica
        variants (``key@...``) that are not in ``keep``: an endpoint
        hot-reload that changes the replica count must not leave stale
        entries pinning dead engines' state or exporting frozen series
        (docs/replication.md)."""
        keep = set(keep)
        with self._lock:
            stale = [
                k for k in self._entries
                if (k == key or k.startswith(key + "@")) and k not in keep
            ]
            for k in stale:
                self._entries.pop(k, None)

    def _snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._entries)

    def describe(self):
        # empty describe => prometheus_client registers without probing
        # collect() (providers may not be fully constructed yet)
        return []


class PrefixCacheCollector(_KeyedCollector):
    """Live LLM prefix-cache observability (llm/prefix_cache.py
    RadixPrefixCache): collect() reads each registered cache's counters —
    and, on the paged backend, the page pool's sharing/CoW counters — at
    scrape time, so the hit rate and HBM dedup of "millions of users share a
    system prompt" traffic are visible without the engine pushing samples
    anywhere.

    ONE collector per registry holds an entry per model (label ``model``):
    re-registering a model (endpoint hot-reload rebuilds its engine)
    REPLACES its entry, dropping the dead engine's cache reference — a
    per-engine collector would both leak the old cache's device KV and emit
    duplicate metric families, which makes Prometheus reject the scrape.
    Replica-fleet entries (docs/replication.md) register per replica with
    ``model``/``replica`` overrides: their samples carry the same
    {model, replica} label split as the lifecycle families (never a
    mangled model label), while legacy entries keep the historical
    {model} shape."""

    def __init__(self, prefix: str = "llm_prefix_cache"):
        super().__init__(prefix)

    def set_entry(self, key: str, cache, pool=None, *, model=None,
                  replica=None) -> None:
        super().set_entry(key, (cache, pool, model, replica))

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )

        entries = self._snapshot()
        p = self._prefix

        def labels(key, model, replica, extra=None):
            out = {"model": str(model or key)}
            if replica is not None:
                out["replica"] = str(replica)
            if extra:
                out.update({k: str(v) for k, v in extra.items()})
            return out

        # hit counter carries the serving TIER (docs/kv_tiering.md): hbm =
        # the whole run was resident, host = it needed promotion from the
        # host-RAM tier; sum over tier = total hits
        hits = CounterMetricFamily(
            p + "_hits", "prefix-cache lookups that matched >= 1 block, by "
            "serving tier (hbm = resident, host = promoted from host RAM)")
        cache_fams = [
            ("misses", "_total", CounterMetricFamily(
                p + "_misses", "prefix-cache lookups with no shared block")),
            ("hit_tokens", "_total", CounterMetricFamily(
                p + "_hit_tokens", "prompt tokens served from cached KV "
                "(prefill compute skipped)")),
            ("evictions", "_total", CounterMetricFamily(
                p + "_evictions", "radix-tree leaf evictions")),
            ("nodes", "", GaugeMetricFamily(
                p + "_nodes", "cached block-granular tree nodes")),
            ("cached_bytes", "", GaugeMetricFamily(
                p + "_bytes", "bytes of KV held (dense) or referenced "
                "(paged) by the cache")),
            ("cached_pages", "", GaugeMetricFamily(
                p + "_pages", "KV pool pages referenced by the cache (paged "
                "backend)")),
        ]
        shared = GaugeMetricFamily(
            "kv_pool_shared_pages",
            "pool pages with more than one reference (slot+cache or "
            "slot+slot zero-copy sharing)",
        )
        free = GaugeMetricFamily(
            "kv_pool_free_pages", "unreferenced pool pages"
        )
        cow = CounterMetricFamily(
            "kv_pool_cow_events",
            "copy-on-write page duplications (live slot extended into a "
            "shared page)",
        )
        any_pool = False
        for key, (cache, pool, model, replica) in entries.items():
            if not hasattr(cache, "stats"):
                # routing-only prefix probes (process-backend proxies)
                # have no stats surface; a single bad entry must not
                # poison the whole registry scrape
                continue
            stats = cache.stats()
            by_tier = stats.get("hits_by_tier") or {
                "hbm": stats.get("hits", 0)
            }
            for tier_name, count in by_tier.items():
                hits.add_sample(
                    hits.name + "_total",
                    labels(key, model, replica, {"tier": tier_name}), count,
                )
            for stat_key, suffix, fam in cache_fams:
                fam.add_sample(
                    fam.name + suffix, labels(key, model, replica),
                    stats[stat_key],
                )
            if pool is not None:
                any_pool = True
                row = labels(key, model, replica)
                shared.add_sample(shared.name, row, pool.shared_pages)
                free.add_sample(free.name, row, pool.free_pages)
                cow.add_sample(cow.name + "_total", row, pool.cow_events)
        yield hits
        for _, _, fam in cache_fams:
            yield fam
        if any_pool:
            yield shared
            yield free
            yield cow


class EngineLifecycleCollector(_KeyedCollector):
    """Request-lifecycle observability (docs/robustness.md): shed / deadline
    / watchdog / step-failure counters plus queue-depth and active-slot
    gauges, read live from each registered provider at scrape time so
    shedding decisions are observable next to what triggered them.

    A provider is a zero-arg callable returning the engine's
    ``lifecycle_stats()`` dict; unknown
    keys are ignored so providers can grow without a collector change. One
    collector per registry holds an entry per model key — re-registering a
    key REPLACES its provider (engine hot-reload must not leak the old
    engine or duplicate families)."""

    def __init__(self, prefix: str = "engine"):
        super().__init__(prefix)

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
            HistogramMetricFamily,
        )

        providers = self._snapshot()
        rows = []
        for key, provider in providers.items():
            try:
                s = provider() or {}
            except Exception:
                continue
            rows.append((key, s))

        # label shape is PER ROW (docs/replication.md): a provider that
        # reports a `replica` id gets the replica label on its samples —
        # two replicas of one model would otherwise emit duplicate series
        # and Prometheus rejects the scrape — while providers without one
        # keep the historical {model} label set. Deciding this per row
        # (raw samples, not add_metric) means a fleet endpoint registering
        # on a shared registry never changes a LEGACY endpoint's series
        # identity: dashboards on engine_ready{model="A"} keep matching
        # when endpoint B scales out, and nothing flaps when B is evicted.
        def _labels(key, s, extra=None):
            out = {"model": str(s.get("model") or key)}
            if "replica" in s:
                out["replica"] = str(s["replica"])
            if extra:
                out.update({k: str(v) for k, v in extra.items()})
            return out

        def gauge(fam, key, s, value, **extra):
            fam.add_sample(fam.name, _labels(key, s, extra), value)

        def counter(fam, key, s, value, **extra):
            # CounterMetricFamily strips a trailing _total from its name;
            # sample names re-append it (same as add_metric)
            fam.add_sample(fam.name + "_total", _labels(key, s, extra), value)

        def hist(fam, key, s, snap, **extra):
            labels = _labels(key, s, extra)
            buckets, total = _hist_buckets(snap)
            for edge, cum in buckets:
                fam.add_sample(
                    fam.name + "_bucket", dict(labels, le=edge), cum
                )
            if buckets:
                # +Inf is last and provides the count (add_metric parity)
                fam.add_sample(fam.name + "_count", labels, buckets[-1][1])
            fam.add_sample(fam.name + "_sum", labels, total)

        p = self._prefix
        # per-class queue depth (docs/slo_scheduling.md): one series per
        # priority class plus class="all" for the total; providers that
        # report only a plain queue_depth int emit class="all"
        queue_depth = GaugeMetricFamily(
            p + "_queue_depth",
            "requests waiting in the engine's admission queue, by priority "
            "class (class=\"all\" = total)",
        )
        active_slots = GaugeMetricFamily(
            p + "_active_slots", "decode slots currently generating",
        )
        ready = GaugeMetricFamily(
            p + "_ready", "1 while the engine accepts work (0 = stopped or "
            "watchdog recovery in progress)",
        )
        sheds = CounterMetricFamily(
            p + "_sheds_total",
            "admissions shed at the front door, by reason and priority "
            "class (class=\"all\" = legacy per-reason totals)",
        )
        preemptions = CounterMetricFamily(
            p + "_preemptions_total",
            "batch-lane slots preempted for queued interactive work "
            "(docs/slo_scheduling.md)",
        )
        brownout_stage = GaugeMetricFamily(
            p + "_brownout_stage",
            "staged-degradation level (0 = normal; 1 spec decode off; 2 + "
            "batch token cap; 3 + prefill budget shrunk and best-effort "
            "shed)",
        )
        brownout_score = GaugeMetricFamily(
            p + "_brownout_score",
            "overload pressure score driving the brownout stage",
        )
        deadlines = CounterMetricFamily(
            p + "_deadline_hits_total",
            "requests failed on an elapsed budget",
        )
        trips = CounterMetricFamily(
            p + "_watchdog_trips_total",
            "stalled-loop detections (each failed the in-flight batch and "
            "recovered the loop)",
        )
        failures = CounterMetricFamily(
            p + "_step_failures_total",
            "decode dispatch failures survived by the loop",
        )
        # the jax_grpc client's RETRY_STATS (engines/grpc_client.py)
        grpc = CounterMetricFamily(
            "grpc_client_upstream_total",
            "engine-server gRPC attempts/retries/retry-budget exhaustions",
        )
        # pipelined-decode observability (docs/pipelined_decode.md): stage
        # timing histograms + the live in-flight dispatch queue depth
        inflight = GaugeMetricFamily(
            p + "_pipeline_inflight",
            "decode chunks dispatched but not yet retired",
        )
        pipe_depth = GaugeMetricFamily(
            p + "_pipeline_depth",
            "configured decode pipeline depth (1 = serial)",
        )
        dispatch_ms = HistogramMetricFamily(
            p + "_step_dispatch_ms",
            "host time to enqueue one decode chunk (ms)",
        )
        retire_ms = HistogramMetricFamily(
            p + "_step_retire_ms",
            "host time to sync + emit one retired chunk (ms)",
        )
        # ragged token-budget scheduler (docs/ragged_attention.md): how full
        # each mixed launch ran against its token budget, and how many rows
        # of each phase rode the launches — occupancy and admission
        # interleave are dashboard lines, not log greps
        budget_util = HistogramMetricFamily(
            p + "_step_token_budget_utilization",
            "per ragged step: tokens dispatched / step token budget",
        )
        step_rows = CounterMetricFamily(
            p + "_step_rows",
            "rows carried by ragged mixed launches, by phase "
            "(prefill = admission chunk rows, decode = multi-step token "
            "windows, spec_verify = q=k+1 draft-chain verify rows)",
        )
        ragged_jobs = GaugeMetricFamily(
            p + "_ragged_prefill_jobs",
            "admissions currently mid-prefill in the ragged scheduler",
        )
        ragged_budget = GaugeMetricFamily(
            p + "_step_token_budget",
            "effective ragged step token budget (brownout stage 3 shrinks "
            "it)",
        )
        # multi-step decode rows + spec-as-row (docs/ragged_attention.md):
        # tokens advanced per mixed launch (the dispatch-bubble
        # amortization headline — 1/mean is dispatches-per-decode-token)
        # and the per-launch accepted-draft fraction over verify rows
        tokens_per_launch = HistogramMetricFamily(
            p + "_decode_tokens_per_launch",
            "decode tokens advanced per ragged mixed launch (multi-step "
            "windows + accepted spec tokens)",
        )
        spec_accept = HistogramMetricFamily(
            p + "_spec_acceptance_rate",
            "per ragged launch: mean accepted-draft fraction over its "
            "spec verify rows (accepted / spec_k)",
        )
        # tree-draft verify rows (docs/spec_decode_trees.md): committed
        # root-to-leaf depth per verify row (the acceptance-gap headline
        # vs the chain baseline at equal verify budget) and how often the
        # proposer's drafts came from real history matches rather than
        # the repeat-last fallback
        spec_tree_depth = HistogramMetricFamily(
            p + "_spec_tree_accept_depth",
            "per tree-verify row: accepted root-to-leaf path depth "
            "(tokens committed from the draft tree in one launch)",
        )
        spec_proposer_hits = CounterMetricFamily(
            p + "_spec_proposer_hits_total",
            "verify rows whose draft came from a real proposer history "
            "match (not the repeat-last fallback), by proposer backend",
        )
        # paged KV pool capacity (docs/paged_kv_quant.md): bytes split by
        # kind (kv = data planes, scale = int8 dequant scale rows) plus an
        # info gauge carrying the pool dtype — the int8 capacity win is a
        # dashboard line, not a code comment
        kv_pool_bytes = GaugeMetricFamily(
            p + "_kv_pool_bytes",
            "device HBM held by the paged KV pools, by kind",
        )
        kv_pool_dtype = GaugeMetricFamily(
            p + "_kv_pool_dtype",
            "info gauge (always 1): storage dtype of the paged KV pools",
        )
        # host-RAM KV tier (docs/kv_tiering.md): where the prefix cache's
        # pages live (hbm vs host) and how many moved each way — the
        # capacity-planning signal the tier exists for
        kv_tier_pages = GaugeMetricFamily(
            p + "_kv_tier_pages",
            "prefix-cache KV pages held, by tier (hbm = device pool, "
            "host = pinned host RAM)",
        )
        kv_tier_bytes = GaugeMetricFamily(
            p + "_kv_tier_bytes",
            "prefix-cache KV bytes held, by tier",
        )
        kv_demotions = CounterMetricFamily(
            p + "_kv_demotions",
            "demotion events: batched HBM->host spill rounds (eviction "
            "pressure spilled instead of dropping; pages moved are in "
            "lifecycle_stats kv_tier.demoted_pages_total)",
        )
        kv_promotions = CounterMetricFamily(
            p + "_kv_promotions",
            "promotion events: demoted runs re-onlined to HBM (async DMA "
            "on a host-tier hit, or by reference at a store)",
        )
        # disaggregated prefill/decode (docs/disaggregation.md): pages
        # moved through the KV transport (direction="out" = shipped at a
        # prefill commit, "in" = imported on the decode replica), the
        # per-operation wall time, and the decode-side ship hit rate —
        # >= 0.9 is the clean-path headline (a shipped request's admission
        # recomputes none of the shipped KV)
        kv_ship_pages = CounterMetricFamily(
            p + "_kv_ship_pages",
            "KV pages moved through the cross-replica transport, by "
            "direction (out = exported at a prefill-replica commit, in = "
            "imported on a decode replica)",
        )
        kv_ship_ms = HistogramMetricFamily(
            p + "_kv_ship_ms",
            "per-shipment transport operation wall time (ms), by "
            "direction (out = export+send at commit, in = receive+fenced "
            "import)",
        )
        kv_ship_hit_rate = GaugeMetricFamily(
            p + "_kv_ship_hit_rate",
            "decode-replica ship hit rate: shipped requests whose "
            "admission found the whole storable prefix resident / all "
            "judged shipped requests (clean-path bound: >= 0.9)",
        )
        kv_ship_overlap = GaugeMetricFamily(
            p + "_kv_ship_overlap_ratio",
            "draft-ahead shipping overlap: pages shipped as unsealed "
            "partial frames before the prefill commit / all pages "
            "shipped for committed prefixes (0 = every page waited for "
            "the seal; -> 1 = the seal carried only the held-back tail)",
        )
        # socket KV-wire backend (llm/kv_wire.py): bytes framed onto the
        # wire and the send->ack round trip; absent on the in-heap
        # shared-slab backend, so the series' existence also names the
        # fleet's transport
        kv_ship_wire_bytes = CounterMetricFamily(
            p + "_kv_ship_wire_bytes",
            "KV shipment bytes crossing the socket transport, by "
            "direction (out = framed + sent, in = received + decoded); "
            "only exported by the socket wire backend",
        )
        kv_ship_rtt_ms = HistogramMetricFamily(
            p + "_kv_ship_rtt_ms",
            "socket KV-wire send round-trip time (ms): frame write to "
            "receiver ack, per shipment",
        )
        # ownership discipline (docs/static_analysis.md TPU7xx): the
        # runtime ledger's live holds and its leak findings — a nonzero
        # leak total on an armed engine is a lost release on some
        # exception path, named (resource + acquire site) in the ledger's
        # violation records
        ledger_outstanding = GaugeMetricFamily(
            p + "_ledger_outstanding",
            "resources currently held per the ownership ledger "
            "(TPUSERVE_LEDGER), by resource class (cache-scoped classes "
            "are legitimately nonzero at idle; request-scoped classes "
            "drain to zero)",
        )
        ledger_leaks = CounterMetricFamily(
            p + "_ledger_leaks_total",
            "lost releases found by the ownership ledger's request-exit "
            "and drain audits (each names the leaked resource and its "
            "acquire site in lifecycle_stats()[\"ledger\"])",
        )
        def _hist_buckets(snap):
            """Engine _MsHistogram snapshot -> prometheus cumulative
            (le, count) pairs + sum."""
            edges = [str(b) for b in snap.get("buckets", [])] + ["+Inf"]
            cum, out = 0, []
            for edge, count in zip(edges, snap.get("counts", [])):
                cum += count
                out.append((edge, cum))
            return out, float(snap.get("sum_ms", 0.0))

        any_grpc = False
        any_pipeline = False
        any_kv_pool = False
        any_kv_tier = False
        any_kv_ship = False
        any_kv_wire = False
        any_slo = False
        any_ragged = False
        any_ledger = False
        for key, s in rows:
            kv_pool = s.get("kv_pool") or {}
            if kv_pool:
                any_kv_pool = True
                for kind in ("kv", "scale"):
                    if kind in kv_pool:
                        gauge(kv_pool_bytes, key, s, kv_pool[kind], kind=kind)
                if kv_pool.get("dtype"):
                    gauge(kv_pool_dtype, key, s, 1, dtype=kv_pool["dtype"])
            kv_tier = s.get("kv_tier") or {}
            if kv_tier:
                any_kv_tier = True
                for tier_name, v in (kv_tier.get("pages") or {}).items():
                    gauge(kv_tier_pages, key, s, v, tier=tier_name)
                for tier_name, v in (kv_tier.get("bytes") or {}).items():
                    gauge(kv_tier_bytes, key, s, v, tier=tier_name)
                if "demotions" in kv_tier:
                    counter(kv_demotions, key, s, kv_tier["demotions"])
                if "promotions" in kv_tier:
                    counter(kv_promotions, key, s, kv_tier["promotions"])
            kv_ship = s.get("kv_ship") or {}
            if kv_ship:
                any_kv_ship = True
                counter(kv_ship_pages, key, s,
                        kv_ship.get("ship_pages", 0), direction="out")
                counter(kv_ship_pages, key, s,
                        kv_ship.get("receive_pages", 0), direction="in")
                snap = kv_ship.get("ship_ms")
                if snap:
                    hist(kv_ship_ms, key, s, snap, direction="out")
                snap = kv_ship.get("receive_ms")
                if snap:
                    hist(kv_ship_ms, key, s, snap, direction="in")
                if kv_ship.get("hit_rate") is not None:
                    gauge(kv_ship_hit_rate, key, s, kv_ship["hit_rate"])
                if kv_ship.get("overlap_ratio") is not None:
                    gauge(kv_ship_overlap, key, s,
                          kv_ship["overlap_ratio"])
                wire = (kv_ship.get("transport") or {}).get("wire") or {}
                if wire:
                    any_kv_wire = True
                    counter(kv_ship_wire_bytes, key, s,
                            wire.get("bytes_sent", 0), direction="out")
                    counter(kv_ship_wire_bytes, key, s,
                            wire.get("bytes_received", 0), direction="in")
                    snap = wire.get("rtt_ms")
                    if snap:
                        hist(kv_ship_rtt_ms, key, s, snap)
            ledger_block = s.get("ledger") or {}
            if ledger_block:
                any_ledger = True
                for resource, v in (
                    ledger_block.get("outstanding") or {}
                ).items():
                    gauge(ledger_outstanding, key, s, v, resource=resource)
                if "leaks" in ledger_block:
                    counter(ledger_leaks, key, s, ledger_block["leaks"])
            ragged = s.get("ragged") or {}
            if ragged:
                any_ragged = True
                snap = ragged.get("budget_utilization")
                if snap:
                    hist(budget_util, key, s, snap)
                for phase, v in (ragged.get("step_rows") or {}).items():
                    counter(step_rows, key, s, v, phase=phase)
                if "prefill_jobs" in ragged:
                    gauge(ragged_jobs, key, s, ragged["prefill_jobs"])
                if "effective_budget" in ragged:
                    gauge(ragged_budget, key, s, ragged["effective_budget"])
                snap = ragged.get("tokens_per_launch")
                if snap:
                    hist(tokens_per_launch, key, s, snap)
                snap = ragged.get("spec_acceptance")
                if snap:
                    hist(spec_accept, key, s, snap)
                snap = ragged.get("spec_tree_depth")
                if snap:
                    hist(spec_tree_depth, key, s, snap)
                prop = ragged.get("spec_proposer")
                if prop:
                    counter(spec_proposer_hits, key, s,
                            prop.get("hit", 0),
                            proposer=prop.get("name", "unknown"))
            pipe = s.get("pipeline") or {}
            if pipe:
                any_pipeline = True
                if "inflight" in pipe:
                    gauge(inflight, key, s, pipe["inflight"])
                if "depth" in pipe:
                    gauge(pipe_depth, key, s, pipe["depth"])
                for fam, field in ((dispatch_ms, "dispatch_ms"),
                                   (retire_ms, "retire_ms")):
                    snap = pipe.get(field)
                    if snap:
                        hist(fam, key, s, snap)
            qd_classes = s.get("queue_depths")
            if isinstance(qd_classes, dict):
                for cls_name, v in qd_classes.items():
                    gauge(queue_depth, key, s, v, **{"class": cls_name})
            if "queue_depth" in s:
                gauge(queue_depth, key, s, s["queue_depth"],
                      **{"class": "all"})
            if "active_slots" in s:
                gauge(active_slots, key, s, s["active_slots"])
            if "ready" in s:
                gauge(ready, key, s, s["ready"])
            by_class = s.get("sheds_by_class")
            if isinstance(by_class, dict):
                for reason, per in by_class.items():
                    for cls_name, v in (per or {}).items():
                        counter(sheds, key, s, v, reason=reason,
                                **{"class": cls_name})
            for reason, v in (s.get("sheds") or {}).items():
                counter(sheds, key, s, v, reason=reason, **{"class": "all"})
            if "preemptions" in s:
                any_slo = True
                counter(preemptions, key, s, s["preemptions"])
            brown = s.get("brownout")
            if isinstance(brown, dict):
                any_slo = True
                gauge(brownout_stage, key, s, brown.get("stage", 0))
                gauge(brownout_score, key, s, brown.get("score", 0.0))
            for stage, v in (s.get("deadlines") or {}).items():
                counter(deadlines, key, s, v, stage=stage)
            if "watchdog_trips" in s:
                counter(trips, key, s, s["watchdog_trips"])
            if "step_failures" in s:
                counter(failures, key, s, s["step_failures"])
            for kind, v in (s.get("grpc") or {}).items():
                any_grpc = True
                counter(grpc, key, s, v, kind=kind)
        yield queue_depth
        yield active_slots
        yield ready
        yield sheds
        yield deadlines
        yield trips
        yield failures
        if any_slo:
            yield preemptions
            yield brownout_stage
            yield brownout_score
        if any_pipeline:
            yield inflight
            yield pipe_depth
            yield dispatch_ms
            yield retire_ms
        if any_ragged:
            yield budget_util
            yield step_rows
            yield ragged_jobs
            yield ragged_budget
            yield tokens_per_launch
            yield spec_accept
            yield spec_tree_depth
            yield spec_proposer_hits
        if any_kv_pool:
            yield kv_pool_bytes
            yield kv_pool_dtype
        if any_kv_tier:
            yield kv_tier_pages
            yield kv_tier_bytes
            yield kv_demotions
            yield kv_promotions
        if any_kv_ship:
            yield kv_ship_pages
            yield kv_ship_ms
            yield kv_ship_hit_rate
            yield kv_ship_overlap
        if any_kv_wire:
            yield kv_ship_wire_bytes
            yield kv_ship_rtt_ms
        if any_ledger:
            yield ledger_outstanding
            yield ledger_leaks
        if any_grpc:
            yield grpc



class ReplicaRouterCollector(_KeyedCollector):
    """Replica-fleet routing observability (docs/replication.md): ring
    size, per-(replica, route) request counters and ejection/re-admission
    events, read live from each registered router provider at scrape time.
    A provider is a zero-arg callable returning ``ReplicaRouter.stats()``
    (optionally with a ``model`` key overriding the entry key as the model
    label). One collector per registry, one entry per model key —
    re-registering a key replaces its provider (endpoint hot-reload)."""

    def __init__(self, prefix: str = "router"):
        super().__init__(prefix)

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )

        providers = self._snapshot()
        p = self._prefix
        ring_size = GaugeMetricFamily(
            p + "_ring_size",
            "replicas currently serving traffic (ready + warm)",
            labels=["model"],
        )
        replicas = GaugeMetricFamily(
            p + "_replicas",
            "replicas configured in the engine group",
            labels=["model"],
        )
        requests = CounterMetricFamily(
            p + "_requests_total",
            "routing decisions, by replica, route and role (affine = HRW "
            "first choice, spill = load-aware second choice, rebalance = "
            "health/eject reroute; role = the replica's prefill/decode/"
            "hybrid specialization, docs/disaggregation.md); decisions "
            "can exceed served requests when a stale pin re-routes "
            "between admission and generation",
            labels=["model", "replica", "route", "role"],
        )
        ejections = CounterMetricFamily(
            p + "_ejections_total",
            "ring ejections (engine not ready, or fault-forced via the "
            "router.eject seam)", labels=["model", "replica", "role"],
        )
        readmissions = CounterMetricFamily(
            p + "_readmissions_total",
            "ring re-admissions after recovery (each re-warmed through "
            "the warmup gate first)",
            labels=["model", "replica", "role"],
        )
        role_members = GaugeMetricFamily(
            p + "_role_members",
            "ring members currently serving, by replica role "
            "(docs/disaggregation.md; hybrid-only fleets report every "
            "member as hybrid)", labels=["model", "role"],
        )
        fleet_stage = GaugeMetricFamily(
            p + "_fleet_brownout_stage",
            "fleet brownout stage: the minimum stage over ring members "
            "(what the least-pressured replica can still absorb)",
            labels=["model"],
        )
        fleet_sheds = CounterMetricFamily(
            p + "_fleet_sheds_total",
            "requests shed at the router door by the fleet-wide brownout, "
            "by priority class", labels=["model", "class"],
        )
        # info gauge (value always 1): which replica backend the fleet
        # runs on — "inprocess" (N engines on one heap) or "process"
        # (supervised worker subprocesses, serving/process_replica.py)
        replica_backend = GaugeMetricFamily(
            p + "_replica_backend",
            "replica backend info gauge: value 1 on the series whose "
            "backend label names the fleet's backend (inprocess | process)",
            labels=["model", "backend"],
        )
        for key, provider in providers.items():
            try:
                s = provider() or {}
            except Exception:
                continue
            model = str(s.get("model") or key)
            roles = s.get("roles") or {}

            def role_of(name):
                return str(roles.get(name, "hybrid"))

            if "ring_size" in s:
                ring_size.add_metric([model], s["ring_size"])
            if "replicas" in s:
                replicas.add_metric([model], s["replicas"])
            if s.get("replica_backend"):
                replica_backend.add_metric(
                    [model, str(s["replica_backend"])], 1
                )
            for name, routes in (s.get("requests") or {}).items():
                for route, v in (routes or {}).items():
                    requests.add_metric(
                        [model, str(name), str(route), role_of(name)], v
                    )
            for name, v in (s.get("ejections") or {}).items():
                ejections.add_metric([model, str(name), role_of(name)], v)
            for name, v in (s.get("readmissions") or {}).items():
                readmissions.add_metric([model, str(name), role_of(name)], v)
            ring = set(s.get("ring") or [])
            if ring or roles:
                by_role = {}
                for name in ring:
                    by_role[role_of(name)] = by_role.get(role_of(name), 0) + 1
                for role in ("prefill", "decode", "hybrid"):
                    if role in by_role or role in roles.values():
                        role_members.add_metric(
                            [model, role], by_role.get(role, 0)
                        )
            brown = s.get("fleet_brownout") or {}
            if "stage" in brown:
                fleet_stage.add_metric([model], brown["stage"])
            for cls, v in (s.get("fleet_sheds") or {}).items():
                fleet_sheds.add_metric([model, str(cls)], v)
        yield ring_size
        yield replicas
        yield requests
        yield ejections
        yield readmissions
        yield role_members
        yield fleet_stage
        yield fleet_sheds
        yield replica_backend



# one collector per live registry (weak: test registries die with their
# tests; a reused id must not resurrect a collector bound to a dead one)
_prefix_collectors: "weakref.WeakKeyDictionary" = None  # lazy init
_lifecycle_collectors: "weakref.WeakKeyDictionary" = None  # lazy init
_router_collectors: "weakref.WeakKeyDictionary" = None  # lazy init


def register_replica_router(provider, registry=REGISTRY, key: str = "llm",
                            prefix: str = "router"):
    """Expose live replica-router metrics for ``key`` (model/endpoint
    name). ``provider`` is a zero-arg callable returning a
    ``ReplicaRouter.stats()``-shaped dict. Idempotent per (registry, key):
    re-registering replaces the provider. Returns the shared collector."""
    global _router_collectors
    import weakref

    if _router_collectors is None:
        _router_collectors = weakref.WeakKeyDictionary()
    per_registry = _router_collectors.setdefault(registry, {})
    collector = per_registry.get(prefix)
    if collector is None:
        collector = ReplicaRouterCollector(prefix)
        registry.register(collector)
        per_registry[prefix] = collector
    collector.set_entry(key, provider)
    return collector


def register_engine_lifecycle(provider, registry=REGISTRY, key: str = "llm",
                              prefix: str = "engine"):
    """Expose live request-lifecycle metrics for ``key`` (model/endpoint
    name). ``provider`` is a zero-arg callable returning a
    ``lifecycle_stats()``-shaped dict. Idempotent per (registry, key):
    re-registering replaces the provider. Returns the shared collector."""
    global _lifecycle_collectors
    import weakref

    if _lifecycle_collectors is None:
        _lifecycle_collectors = weakref.WeakKeyDictionary()
    per_registry = _lifecycle_collectors.setdefault(registry, {})
    collector = per_registry.get(prefix)
    if collector is None:
        collector = EngineLifecycleCollector(prefix)
        registry.register(collector)
        per_registry[prefix] = collector
    collector.set_entry(key, provider)
    return collector


def register_prefix_cache(cache, pool=None, registry=REGISTRY,
                          key: str = "llm",
                          prefix: str = "llm_prefix_cache",
                          model: Optional[str] = None,
                          replica: Optional[str] = None):
    """Expose live prefix-cache metrics for ``key`` (the model/endpoint
    name). Idempotent per (registry, key): re-registering replaces the
    entry, so engine hot-reloads neither leak the old cache nor duplicate
    metric families. Replica-fleet callers register one entry per replica
    under a unique key with ``model``/``replica`` overrides — samples then
    carry the {model, replica} label split (docs/replication.md). Returns
    the registry's shared collector."""
    global _prefix_collectors
    import weakref

    if _prefix_collectors is None:
        _prefix_collectors = weakref.WeakKeyDictionary()
    per_registry = _prefix_collectors.setdefault(registry, {})
    collector = per_registry.get(prefix)
    if collector is None:
        collector = PrefixCacheCollector(prefix)
        registry.register(collector)
        per_registry[prefix] = collector
    collector.set_entry(key, cache, pool, model=model, replica=replica)
    return collector



def _registry_collector(store, registry, prefix):
    if store is None:
        return None
    try:
        return store.get(registry, {}).get(prefix)
    except TypeError:
        return None


def prune_prefix_caches(key, keep, registry=REGISTRY,
                        prefix: str = "llm_prefix_cache") -> None:
    """Drop stale per-replica prefix-cache entries for ``key`` (see
    collector.prune_entries). No-op when no collector exists yet."""
    collector = _registry_collector(_prefix_collectors, registry, prefix)
    if collector is not None:
        collector.prune_entries(key, keep)


def prune_engine_lifecycle(key, keep, registry=REGISTRY,
                           prefix: str = "engine") -> None:
    """Drop stale per-replica lifecycle providers for ``key``."""
    collector = _registry_collector(_lifecycle_collectors, registry, prefix)
    if collector is not None:
        collector.prune_entries(key, keep)


def prune_replica_router(key, keep, registry=REGISTRY,
                         prefix: str = "router") -> None:
    """Drop stale router providers for ``key`` (e.g. a fleet endpoint
    reloaded as a single engine)."""
    collector = _registry_collector(_router_collectors, registry, prefix)
    if collector is not None:
        collector.prune_entries(key, keep)


class StatisticsController:
    _sync_threshold_sec = 30.0

    def __init__(
        self,
        broker_url: str,
        processor=None,  # ModelRequestProcessor for metric-spec sync (optional)
        registry=REGISTRY,
        poll_frequency_sec: float = 60.0,
    ):
        self._consumer = make_consumer(broker_url)
        self._processor = processor
        self._registry = registry
        self._poll_frequency_sec = poll_frequency_sec
        self._collectors: Dict[str, Dict[str, Any]] = {}
        self._metric_specs: Dict[str, Dict[str, dict]] = {}
        self._last_sync = 0.0
        self._stop_event = threading.Event()
        self._device_gauges_ready = False

    # -- spec sync -----------------------------------------------------------

    def sync_specs(self) -> None:
        if self._processor is None:
            return
        try:
            self._processor.deserialize(skip_sync=True)
        except Exception:
            pass
        specs: Dict[str, Dict[str, dict]] = {}
        for name, spec in self._processor.list_endpoint_logging().items():
            specs[name] = {k: v.as_dict() for k, v in spec.metrics.items()}
        self._metric_specs = specs
        self._last_sync = time.time()
        # Drop cached "no spec" sentinels so variables whose spec arrived after
        # their first observation start exporting without a restart.
        for per_ep in self._collectors.values():
            for variable in [k for k, v in per_ep.items() if v is None]:
                del per_ep[variable]

    def _spec_for(self, url: str) -> Dict[str, dict]:
        if url in self._metric_specs:
            return self._metric_specs[url]
        for name, metrics in self._metric_specs.items():
            if name.endswith("/*") and url.startswith(name[:-1]):
                return metrics
        # unknown endpoint: reserved-only logging + throttled re-sync
        if time.time() - self._last_sync > self._sync_threshold_sec:
            self.sync_specs()
            if url in self._metric_specs:
                return self._metric_specs[url]
        return {}

    # -- collectors -----------------------------------------------------------

    def _collector(self, url: str, variable: str) -> Optional[Any]:
        per_ep = self._collectors.setdefault(url, {})
        if variable in per_ep:
            return per_ep[variable]
        full_name = _sanitize("{}:{}".format(url, variable))
        collector = None
        if variable == "_latency":
            collector = ("histogram", Histogram(
                full_name, "Request latency for {}".format(url),
                buckets=_LATENCY_BUCKETS, registry=self._registry,
            ))
        elif variable == "_count":
            collector = ("counter", Counter(
                full_name, "Estimated request count for {}".format(url),
                registry=self._registry,
            ))
        else:
            spec = self._spec_for(url).get(variable)
            if spec is None:
                per_ep[variable] = None
                return None
            mtype = spec.get("type", "value")
            if mtype == "scalar":
                buckets = sorted(float(b) for b in (spec.get("buckets") or []))
                if not buckets:
                    buckets = list(_LATENCY_BUCKETS)
                if buckets[-1] != float("inf"):
                    buckets.append(float("inf"))
                collector = ("histogram", Histogram(
                    full_name, "scalar {} for {}".format(variable, url),
                    buckets=buckets, registry=self._registry,
                ))
            elif mtype == "enum":
                declared = [str(b) for b in (spec.get("buckets") or [])]
                if len(declared) >= 2:
                    # declared bucket set -> reference-parity EnumHistogram
                    # (fixed buckets, declared ordering)
                    collector = ("enum_hist", EnumHistogram(
                        full_name, "enum {} for {}".format(variable, url),
                        declared, registry=self._registry,
                    ))
                else:
                    # spec-less enum: dynamic value set via labeled Counter
                    collector = ("enum", Counter(
                        full_name, "enum {} for {}".format(variable, url),
                        labelnames=("value",), registry=self._registry,
                    ))
            elif mtype == "counter":
                collector = ("counter", Counter(
                    full_name, "counter {} for {}".format(variable, url),
                    registry=self._registry,
                ))
            else:
                collector = ("gauge", Gauge(
                    full_name, "value {} for {}".format(variable, url),
                    registry=self._registry,
                ))
        per_ep[variable] = collector
        return collector

    def _observe(self, url: str, variable: str, value: Any, count_weight: int) -> None:
        entry = self._collector(url, variable)
        if entry is None:
            return
        kind, collector = entry
        values = value if isinstance(value, (list, tuple)) else [value]
        for v in values:
            try:
                if kind == "histogram":
                    collector.observe(float(v))
                elif kind == "enum_hist":
                    collector.observe(v)
                elif kind == "enum":
                    collector.labels(value=str(v)).inc()
                elif kind == "counter":
                    collector.inc(float(v))
                else:
                    collector.set(float(v))
            except (TypeError, ValueError):
                continue

    # -- consumption -----------------------------------------------------------

    def process_batch(self, batch) -> int:
        n = 0
        for stats in batch:
            url = stats.get("_url")
            if not url:
                continue
            count_weight = int(stats.get("_count", 1))
            for variable, value in stats.items():
                if variable == "_url":
                    continue
                if variable == "_count":
                    entry = self._collector(url, "_count")
                    if entry:
                        entry[1].inc(count_weight)
                    continue
                self._observe(url, variable, value, count_weight)
            n += 1
        return n

    def update_device_gauges(self) -> None:
        """Per-card memory gauges; a no-op where this process has no CUDA
        context (never makes one)."""
        try:
            import torch

            if not torch.cuda.is_initialized():
                return
            devices = range(torch.cuda.device_count())
        except Exception:
            return
        if not self._device_gauges_ready:
            self._hbm_used = Gauge(
                "tpu_hbm_bytes_in_use", "HBM bytes in use", labelnames=("device",),
                registry=self._registry,
            )
            self._hbm_limit = Gauge(
                "tpu_hbm_bytes_limit", "HBM bytes limit", labelnames=("device",),
                registry=self._registry,
            )
            self._device_gauges_ready = True
        for index in devices:
            try:
                stats = torch.cuda.memory_stats(index)
                _free, total = torch.cuda.mem_get_info(index)
            except Exception:
                continue
            if "allocated_bytes.all.current" in stats:
                self._hbm_used.labels(device=str(index)).set(
                    stats["allocated_bytes.all.current"])
            if total:
                self._hbm_limit.labels(device=str(index)).set(total)

    def start(self) -> None:
        """Blocking consume loop (run in the statistics container main)."""
        self.sync_specs()
        last_spec_sync = time.time()
        while not self._stop_event.is_set():
            batch = self._consumer.poll() if self._consumer else []
            if batch:
                self.process_batch(batch)
            self.update_device_gauges()
            if time.time() - last_spec_sync > self._poll_frequency_sec:
                self.sync_specs()
                last_spec_sync = time.time()
            if not batch:
                self._stop_event.wait(timeout=1.0)

    def stop(self) -> None:
        self._stop_event.set()
