"""Filtered-ANN engine on PyTorch: label bitmaps, predicates, datasets,
the six filtered-ANN methods and the serving surface (`FilteredIndex` +
`QueryBatch`/`SearchResult` + `RouterService`, scaled out by
`ShardedFilteredIndex`, made writable by `LiveFilteredIndex`/
`ShardedLiveIndex`, and made durable by `IndexStore` — segment files,
write-ahead log, stable external keys, crash recovery — in the JAX
package's on-disk formats), and the serving-ops layer: `Span`/`Tracer`
from `trace`, `SemanticResultCache` from `cache`, `TelemetrySink`/
`RecallAuditor`/`OnlineBenchmarkTable`/`OnlineRouterAdapter` from
`telemetry`, `SLOEngine` from `slo`, `WideEventLog` from `obslog`, and
`metrics_text`/`MetricsServer` from `metrics`.

The names below resolve on first use, so importing any one module of the
package (a kernel wrapper, say) does not import the whole serving stack
and its import cycles."""

import importlib

_EXPORTS = {"Predicate": "predicates", "ANNDataset": "dataset",
            "FilteredIndex": "index", "QueryBatch": "index",
            "RoutingDecision": "index", "SearchResult": "index",
            "ShardedFilteredIndex": "sharded",
            "LiveFilteredIndex": "live", "LiveSnapshot": "live",
            "ShardedLiveIndex": "live", "IndexStore": "store",
            "WriteAheadLog": "store", "Span": "trace", "Tracer": "trace",
            "SemanticResultCache": "cache", "TelemetrySink": "telemetry",
            "RecallAuditor": "telemetry",
            "OnlineBenchmarkTable": "telemetry",
            "OnlineRouterAdapter": "telemetry", "SLOEngine": "slo",
            "Objective": "slo", "WideEventLog": "obslog",
            "metrics_text": "metrics", "MetricsServer": "metrics"}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
