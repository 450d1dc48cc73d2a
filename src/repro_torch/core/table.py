"""The offline benchmark table B (paper Eq. 6):

    B[ds, pt, m, ps] = (recall, QPS)

built by benchmarking every (method, parameter setting) on every
(dataset, predicate type) combination, as the paper's offline stage
does. A plain copy of the JAX package's table: the same JSON file format,
so one table file opens in either package."""

from __future__ import annotations

import dataclasses
import json

# version-stamped table file (legacy bare-list files read as version 0)
TABLE_FORMAT = "repro.benchmark-table"
TABLE_VERSION = 1


def table_file_version(path: str) -> int:
    """Version stamp of a saved table file (0 for the legacy bare-list
    format). Raises ValueError if the file is not a benchmark table."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):
        return 0
    if isinstance(data, dict) and data.get("format") == TABLE_FORMAT:
        return int(data.get("version", -1))
    raise ValueError(f"{path!r} is not a benchmark table file")


@dataclasses.dataclass
class BenchmarkTable:
    entries: dict  # (ds, pt:int, method, ps_id) -> {"recall": float, "qps": float}

    @staticmethod
    def new() -> "BenchmarkTable":
        return BenchmarkTable(entries={})

    def add(self, ds: str, pt: int, method: str, ps_id: str,
            recall: float, qps: float) -> None:
        self.entries[(ds, int(pt), method, ps_id)] = {
            "recall": float(recall), "qps": float(qps)}

    def copy(self) -> "BenchmarkTable":
        """Deep-enough copy: fresh entries dict with fresh cell dicts."""
        return BenchmarkTable(
            entries={k: dict(v) for k, v in self.entries.items()})

    def settings(self, ds: str, pt: int, method: str):
        out = []
        for (d, p, m, ps_id), v in self.entries.items():
            if (d, p, m) == (ds, int(pt), method):
                out.append((ps_id, v))
        return out

    def best_qps_setting(self, ds: str, pt: int, method: str, t: float):
        """argmax_ps QPS s.t. recall >= T  (Alg. 2 line 8); None if no
        setting meets T."""
        cands = [(ps_id, v) for ps_id, v in self.settings(ds, pt, method)
                 if v["recall"] >= t]
        if not cands:
            return None
        return max(cands, key=lambda kv: kv[1]["qps"])

    def max_recall_setting(self, ds: str, pt: int, method: str):
        """Fallback (Alg. 2 line 14): the max-recall setting."""
        cands = self.settings(ds, pt, method)
        if not cands:
            return None
        return max(cands, key=lambda kv: (kv[1]["recall"], kv[1]["qps"]))

    def routing_arrays(self, ds: str, pt: int, methods: list, t: float):
        """Per-method routing tables for the vectorised Algorithm 2.

        Returns (has_pass [M] bool, qps [M] float, ps_pass [M] ps_id|None,
        ps_fallback [M] ps_id|None): the best-QPS setting meeting T per
        method, and the fallback setting (best-QPS-meeting-T, else
        max-recall) used when no method passes the threshold.
        """
        import numpy as np

        m = len(methods)
        has_pass = np.zeros(m, dtype=bool)
        qps = np.full(m, -np.inf)
        ps_pass = np.empty(m, dtype=object)
        ps_fallback = np.empty(m, dtype=object)
        for j, name in enumerate(methods):
            hit = self.best_qps_setting(ds, pt, name, t)
            if hit is not None:
                has_pass[j] = True
                ps_pass[j] = hit[0]
                qps[j] = hit[1]["qps"]
            fb = hit or self.max_recall_setting(ds, pt, name)
            ps_fallback[j] = fb[0] if fb else None
        return has_pass, qps, ps_pass, ps_fallback

    # ---- persistence ----
    def save(self, path: str) -> None:
        """Write the version-stamped table file (format, version, rows)."""
        rows = [{"ds": k[0], "pt": k[1], "method": k[2], "ps": k[3], **v}
                for k, v in self.entries.items()]
        with open(path, "w") as f:
            json.dump({"format": TABLE_FORMAT, "version": TABLE_VERSION,
                       "rows": rows}, f, indent=1)

    @staticmethod
    def load(path: str) -> "BenchmarkTable":
        """Read a saved table: the stamped format, or the legacy bare
        list (version 0). Raises ValueError for a newer-than-supported
        version."""
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            if data.get("format") != TABLE_FORMAT:
                raise ValueError(
                    f"{path!r} is not a {TABLE_FORMAT} file "
                    f"(format={data.get('format')!r})")
            if int(data.get("version", -1)) > TABLE_VERSION:
                raise ValueError(
                    f"table file version {data['version']} is newer than "
                    f"supported version {TABLE_VERSION}")
            rows = data["rows"]
        else:
            rows = data            # legacy pre-stamp list
        t = BenchmarkTable.new()
        for r in rows:
            t.add(r["ds"], r["pt"], r["method"], r["ps"], r["recall"], r["qps"])
        return t
