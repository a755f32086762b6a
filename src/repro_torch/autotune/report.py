"""Markdown rendering of one sweep result (pure: doc dict -> str) — port
of ``repro/autotune/report.py``.

The doc is exactly the ``BENCH_autotune.json`` payload the driver
writes, so the report can be regenerated from the JSON alone — and a
fully-cache-hit resume rewrites it byte-identically. The reference's
lines, with two differences: the throughput is *measured* (the
trade-off line says so), and the report ends with a "Measured on"
section — the card's name and power limit and each serving path's
seconds per step, from the doc's ``throughput`` row.
"""
from __future__ import annotations

from typing import List


def _fmt(v, nd: int = 3) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _table(headers: List[str], rows: List[List[str]]) -> List[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    out += ["| " + " | ".join(r) + " |" for r in rows]
    return out


def _bits_of(rec: dict) -> str:
    if rec["trial"]["kind"] == "uniform":
        return rec["trial"]["recipe"]["bits"]
    alloc = rec.get("allocation") or []
    return "[" + " ".join(b.replace("w", "").split("a")[0]
                          for b in alloc) + "]"


def render_report(doc: dict) -> str:
    meta = doc["meta"]
    model = meta["model"]["cfg"]
    lines = [
        "# Autotune sweep report",
        "",
        f"Model: `{meta['model']['class']}` d_model={model['d_model']} "
        f"layers={model['n_layers']} img={model['img_size']} — "
        f"T={meta['dif']['T']}, {meta['dif']['tgq_groups']} TGQ groups.",
        f"Space `{meta['space_hash']}` × eval protocol "
        f"`{meta['eval_hash']}`: {doc['n_trials']} trials, "
        f"{doc['n_pruned']} pruned at stage 1.",
        "",
        "## Pareto frontier (fastest → highest quality)",
        "",
    ]
    rows = [[p["label"], _fmt(p.get("bits") or
                              "mean " + _fmt(p.get("mean_bits"), 2) + "b"),
             _fmt(p["req_per_s"], 2), _fmt(p["ms_per_step"], 2),
             _fmt(p["FD"]), _fmt(p["sFD"]), _fmt(p["IS*"]),
             _fmt(p["noise_mse"], 5), f"`{p['artifact']}`"]
            for p in doc["frontier"]]
    lines += _table(["recipe", "bits", "req/s", "ms/step", "FD", "sFD",
                     "IS*", "noise-MSE", "artifact"], rows)
    lines += [
        "",
        "Strict quality-vs-throughput trade-off along the frontier: "
        + ("**yes** — FD strictly improves as measured req/s falls."
           if doc["strict_tradeoff"] else
           "**no** (duplicate objective values survived — inspect "
           "trials)."),
        "",
        "## All trials",
        "",
    ]
    rows = []
    for r in sorted(doc["trials"],
                    key=lambda r: -r["metrics"]["req_per_s"]):
        m = r["metrics"]
        rows.append([r["label"], _bits_of(r), r["status"],
                     _fmt(m["req_per_s"], 2), _fmt(m.get("FD")),
                     _fmt(m["noise_mse"], 5), r["key"]])
    lines += _table(["recipe", "bits", "status", "req/s", "FD",
                     "noise-MSE", "ledger key"], rows)

    mixed = [r for r in doc["trials"] if r["trial"]["kind"] == "mixed"]
    if mixed:
        lines += ["", "## Mixed-precision allocations", "",
                  "Per-TGQ-group weight bits chosen greedily from the "
                  "components' per-group noise-MSE sensitivity under "
                  "each mean-bit budget:", ""]
        rows = [[r["label"], _fmt(r["trial"]["budget"], 2),
                 " ".join(b.replace("w", "").split("a")[0]
                          for b in r["allocation"])]
                for r in mixed]
        lines += _table(["trial", "budget (mean bits)",
                         "bits per group g0..gG"], rows)
    lines += ["", "Every `ok` trial's artifact loads with "
              "`QuantArtifact.load(<out_dir>/artifacts/<key>)`; mixed "
              "trials store `mixed.json` naming their component "
              "artifacts. Resume by re-running the same command — "
              "completed trials cache-hit from `ledger.jsonl`.", ""]
    lines += _measured_on(doc["throughput"])
    return "\n".join(lines)


def _measured_on(row: dict) -> List[str]:
    """The section naming where the throughput axis was taken."""
    lines = ["## Measured on", ""]
    if row["source"] != "measured":
        lines += ["Seconds per step supplied by the caller, not measured.",
                  ""]
    else:
        serve = row["serve"]
        lines += [f"`{row['card']}` ({row['device']}): "
                  f"{serve['b_local']} request(s) of {serve['steps']} "
                  f"CFG-paired steps through the sync `ServeEngine`, "
                  f"d_model={serve['cfg']['d_model']} "
                  f"layers={serve['cfg']['n_layers']}; median of "
                  f"{row['runs']} runs after one warm-up.", ""]
    rows = [[p, _fmt(s * 1e3, 3),
             _fmt(row["spread_s"][p] * 1e3, 3) if "spread_s" in row else "—"]
            for p, s in sorted(row["step_s"].items())]
    lines += _table(["path", "ms/step", "spread ms/step"], rows)
    return lines + [""]
