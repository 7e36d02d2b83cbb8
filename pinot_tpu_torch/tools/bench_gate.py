"""Perf-regression gate over two bench rounds (``BENCH_*.json``).

The port's copy of pinot_tpu/tools/bench_gate.py: a JSON comparator that
touches no device and imports neither torch nor the JAX package, so it
gives the reference's report and exit code on the same two files. Its
round format, key names (``tpu_p50_s``, the platform strings) and rules
are the reference's, so a round of either package compares with one of
the other; a cross-platform pair downgrades timing checks as below.

Reference analogue: the "compare two benchmark result files, fail CI on
regression" pattern (pytest-benchmark ``--benchmark-compare-fail``,
ASV's ``asv compare --factor``). A bench harness emits one JSON per
round; this gate compares a baseline round against a candidate round per
config and exits nonzero when the candidate regressed, naming exactly
which config and by how much.

Round files come in two shapes, both accepted:

- the bench payload itself: ``{"metric": ..., "detail": {config: {...}}}``
  (``.bench_partial/summary.json``, a freshly captured round);
- a runner's wrapper: ``{"cmd", "rc", "parsed", "tail"}`` where
  ``parsed`` may be null and the payload JSON is the last line of
  ``tail`` (BENCH_r04/r05 are stored like this).

Checks per config present in the baseline:

- **p50 regression**: candidate ``tpu_p50_s`` > baseline × (1 +
  ``--threshold``), default 25% — sized above bench noise (repeat rounds
  on idle hardware move p50 by low single digits) — AND the absolute
  delta clears ``--min-abs-ms`` so microsecond-scale configs can't trip
  the ratio on scheduler jitter;
- **match flip**: baseline ``match`` true → candidate false is a
  CORRECTNESS regression and always fails, no threshold;
- **missing config**: a config the baseline measured that the candidate
  dropped fails (silent coverage loss reads as a pass otherwise);
- **shuffled-bytes regression** (MSE configs that record it): candidate
  ``shuffled_bytes`` > baseline × (1 + ``--threshold``) AND at least
  4096 bytes more — a plan regression (lost pushdown, widened exchange
  schema), same WARN-across-platforms downgrade as p50;
- **host-crossings regression** (MSE fused configs that record it): ANY
  increase in ``host_crossings`` fails — the count of device→host
  round-trips is a plan property with zero noise, and an increase means
  a fused stage fell back to per-operator hops;
- **realtime delta-upload regression** (q11r): candidate
  ``rt_delta_bytes`` >= ``rt_full_bytes`` always fails (the incremental
  upload path re-ships the whole snapshot), candidate ``rt_warm_bytes``
  > 0 always fails (the plane-resident fast path re-uploaded on an
  unchanged generation), and delta-bytes growth vs the baseline follows
  the same ratio + 4096-byte-floor rule as shuffled bytes;
- **tiered cold/warm regression** (configs that record them): candidate
  ``cold_p50_s`` / ``warm_p50_s`` past the same ratio + ``--min-abs-ms``
  rules (WARN across platforms); a ``warm_match`` flip true → false
  always fails — the warm resident path returned different rows.

Platform mismatch (cpu round vs tpu round) downgrades p50 checks to
warnings: the ratio would measure the machine, not the code.

Usage::

    python -m pinot_tpu_torch.tools.bench_gate BASELINE.json CANDIDATE.json \
        [--threshold 0.25] [--min-abs-ms 2.0] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _extract_payload(doc) -> dict:
    """Accept either a bench payload or a runner's wrapper around one."""
    if not isinstance(doc, dict):
        raise ValueError("round file is not a JSON object")
    if isinstance(doc.get("detail"), dict):
        return doc
    parsed = doc.get("parsed")
    if isinstance(parsed, dict) and isinstance(parsed.get("detail"), dict):
        return parsed
    tail = doc.get("tail")
    if isinstance(tail, str):
        # the payload is the LAST JSON object printed to the tail; scan
        # candidate start offsets right-to-left so log lines with braces
        # ahead of it don't break the parse
        dec = json.JSONDecoder()
        for i in range(len(tail) - 1, -1, -1):
            if tail[i] != "{":
                continue
            try:
                obj, _end = dec.raw_decode(tail[i:])
            except ValueError:
                continue
            if isinstance(obj, dict) and isinstance(obj.get("detail"), dict):
                return obj
        salvaged = _salvage_configs(tail, dec)
        if salvaged:
            return salvaged
    raise ValueError("no bench payload with a 'detail' section found")


def _salvage_configs(tail: str, dec: "json.JSONDecoder") -> dict:
    """Runner wrappers keep only the LAST ~2000 chars of output, which
    truncates the payload's head (BENCH_r04/r05 landed like this) — but
    whole per-config objects usually survive. Recover every complete
    ``"config_name": {...tpu_p50_s...}`` pair so the gate can still
    compare the configs both rounds kept."""
    import re

    detail = {}
    for m in re.finditer(r'"([A-Za-z_][A-Za-z0-9_]*)":\s*\{', tail):
        try:
            obj, _end = dec.raw_decode(tail[m.end() - 1:])
        except ValueError:
            continue
        if isinstance(obj, dict) and "tpu_p50_s" in obj:
            detail[m.group(1)] = obj
    if not detail:
        return {}
    out = {"detail": detail, "salvaged": True}
    pm = re.search(r'"platform":\s*"([^"]+)"', tail)
    if pm:
        out["platform"] = pm.group(1)
    return out


def load_round(path: str) -> dict:
    return _extract_payload(json.loads(Path(path).read_text()))


def _runner_shape_diff(baseline: dict, candidate: dict):
    """Human-readable diff of the two rounds' runner-shape blocks, or None
    when they match (or either round predates the block). A core-count or
    mesh-size change makes same-platform wall-clock numbers incomparable —
    the r05→r06 q5/q7 "regressions" tracked the runner dropping to one
    physical core, not the code — so timing FAILs downgrade to WARNs that
    name the shape change instead of blaming the candidate round."""
    br = baseline.get("runner")
    cr = candidate.get("runner")
    if not isinstance(br, dict) or not isinstance(cr, dict):
        return None
    diffs = [f"{key} {br.get(key)} -> {cr.get(key)}"
             for key in sorted(set(br) | set(cr))
             if br.get(key) != cr.get(key)]
    return ", ".join(diffs) or None


def compare(baseline: dict, candidate: dict, threshold: float = 0.25,
            min_abs_ms: float = 2.0) -> dict:
    """Pure comparison (importable by tests): returns the gate report
    {pass, failures: [...], rows: [...]} without touching the process."""
    base_cfg = baseline.get("detail") or {}
    cand_cfg = candidate.get("detail") or {}
    base_plat = baseline.get("platform")
    cand_plat = candidate.get("platform")
    cross_platform = bool(base_plat and cand_plat and base_plat != cand_plat)
    shape_diff = _runner_shape_diff(baseline, candidate)
    # wall-clock checks are only comparable on the same platform AND the
    # same runner shape; plan-property checks (match, shuffled bytes, host
    # crossings) ignore the shape — a core count can't change a plan
    timing_noise = cross_platform or bool(shape_diff)
    noise_label = "platforms" if cross_platform \
        else f"runner shapes ({shape_diff})"
    rows = []
    failures = []
    warnings = []
    if cross_platform:
        warnings.append(
            f"platform mismatch (baseline={base_plat}, "
            f"candidate={cand_plat}): p50 checks downgraded to warnings")
    elif shape_diff:
        warnings.append(
            f"runner shape differs ({shape_diff}): timing checks "
            "downgraded to warnings")
    for cfg in base_cfg:
        b = base_cfg[cfg]
        c = cand_cfg.get(cfg)
        if c is None:
            failures.append(f"{cfg}: missing from candidate round")
            rows.append({"config": cfg, "verdict": "MISSING",
                         "baselineP50s": b.get("tpu_p50_s")})
            continue
        bp = float(b.get("tpu_p50_s") or 0.0)
        cp = float(c.get("tpu_p50_s") or 0.0)
        ratio = (cp / bp) if bp > 0 else float("inf")
        delta_ms = (cp - bp) * 1000.0
        row = {"config": cfg, "baselineP50s": round(bp, 6),
               "candidateP50s": round(cp, 6), "ratio": round(ratio, 4),
               "deltaMs": round(delta_ms, 3),
               "baselineMatch": b.get("match"),
               "candidateMatch": c.get("match")}
        verdict = "PASS"
        if b.get("match") is True and c.get("match") is False:
            verdict = "FAIL"
            failures.append(f"{cfg}: result match flipped true -> false "
                            "(correctness regression)")
        elif bp > 0 and ratio > 1.0 + threshold and delta_ms >= min_abs_ms:
            if timing_noise:
                verdict = "WARN"
                warnings.append(
                    f"{cfg}: p50 {bp:.4f}s -> {cp:.4f}s "
                    f"({(ratio - 1) * 100:.1f}% slower) across "
                    f"{noise_label}")
            else:
                verdict = "FAIL"
                failures.append(
                    f"{cfg}: p50 regressed {bp:.4f}s -> {cp:.4f}s "
                    f"({(ratio - 1) * 100:.1f}% slower, threshold "
                    f"{threshold * 100:.0f}%)")
        # mesh round (multi-device sharded dispatch): compared only when
        # BOTH rounds measured it — older rounds predate the mesh mode and
        # a missing side is coverage drift, not a regression. A device-count
        # mismatch downgrades to WARN (the ratio would measure the mesh
        # size, not the code), mirroring the cross-platform rule.
        bm = b.get("mesh_p50_s")
        cm = c.get("mesh_p50_s")
        if bm is not None and cm is not None:
            bmp, cmp_ = float(bm), float(cm)
            mesh_ratio = (cmp_ / bmp) if bmp > 0 else float("inf")
            mesh_delta_ms = (cmp_ - bmp) * 1000.0
            mesh_devices_differ = (b.get("mesh_devices")
                                   != c.get("mesh_devices"))
            row.update({"baselineMeshP50s": round(bmp, 6),
                        "candidateMeshP50s": round(cmp_, 6),
                        "meshRatio": round(mesh_ratio, 4),
                        "baselineMeshDevices": b.get("mesh_devices"),
                        "candidateMeshDevices": c.get("mesh_devices")})
            if b.get("mesh_match") is True and c.get("mesh_match") is False:
                verdict = "FAIL"
                failures.append(
                    f"{cfg}: mesh result match flipped true -> false "
                    "(sharded-dispatch correctness regression)")
            elif bmp > 0 and mesh_ratio > 1.0 + threshold \
                    and mesh_delta_ms >= min_abs_ms:
                if timing_noise or mesh_devices_differ:
                    if verdict == "PASS":
                        verdict = "WARN"
                    warnings.append(
                        f"{cfg}: mesh p50 {bmp:.4f}s -> {cmp_:.4f}s "
                        f"({(mesh_ratio - 1) * 100:.1f}% slower) across "
                        + (noise_label if timing_noise else
                           f"mesh sizes ({b.get('mesh_devices')} -> "
                           f"{c.get('mesh_devices')} devices)"))
                else:
                    verdict = "FAIL"
                    failures.append(
                        f"{cfg}: mesh p50 regressed {bmp:.4f}s -> "
                        f"{cmp_:.4f}s ({(mesh_ratio - 1) * 100:.1f}% "
                        f"slower, threshold {threshold * 100:.0f}%)")
        elif bm is not None and cm is None:
            warnings.append(f"{cfg}: baseline measured a mesh round but "
                            "candidate did not (mesh coverage dropped)")
        # shuffled bytes (MSE configs only — bench.py records the summed
        # cross-stage logical bytes for join configs): compared only when
        # BOTH rounds measured it, same missing-side rule as mesh. Bytes
        # are a plan property, not a wall-clock sample, so the threshold
        # catches plan regressions (a lost pushdown, a widened exchange
        # schema) rather than noise; the 4096-byte absolute floor keeps
        # tiny fixture-sized runs from tripping the ratio on a few rows.
        bs = b.get("shuffled_bytes")
        cs = c.get("shuffled_bytes")
        if bs is not None and cs is not None:
            bsb, csb = int(bs), int(cs)
            byte_ratio = (csb / bsb) if bsb > 0 else float("inf")
            row.update({"baselineShuffledBytes": bsb,
                        "candidateShuffledBytes": csb,
                        "shuffledBytesRatio": round(byte_ratio, 4)
                        if bsb > 0 else None})
            if csb > bsb * (1.0 + threshold) and csb - bsb >= 4096:
                if cross_platform:
                    if verdict == "PASS":
                        verdict = "WARN"
                    warnings.append(
                        f"{cfg}: shuffled bytes {bsb} -> {csb} "
                        f"({(byte_ratio - 1) * 100:.1f}% more) across "
                        "platforms")
                else:
                    verdict = "FAIL"
                    failures.append(
                        f"{cfg}: shuffled bytes regressed {bsb} -> {csb} "
                        f"({(byte_ratio - 1) * 100:.1f}% more, threshold "
                        f"{threshold * 100:.0f}%)")
        elif bs is not None and cs is None:
            warnings.append(f"{cfg}: baseline recorded shuffled_bytes but "
                            "candidate did not (exchange telemetry dropped)")
        # host crossings (MSE fused configs): the count of device→host
        # round-trips the plan took — a PLAN property with no noise, so ANY
        # increase fails (a fused stage falling back to per-operator hops
        # is exactly the regression this check guards against). Same
        # missing-side and cross-platform rules as shuffled bytes (the
        # device-eligibility gate can differ across backends).
        bh = b.get("host_crossings")
        ch = c.get("host_crossings")
        if bh is not None and ch is not None:
            bhc, chc = int(bh), int(ch)
            row.update({"baselineHostCrossings": bhc,
                        "candidateHostCrossings": chc})
            if chc > bhc:
                if cross_platform:
                    if verdict == "PASS":
                        verdict = "WARN"
                    warnings.append(
                        f"{cfg}: host crossings {bhc} -> {chc} across "
                        "platforms")
                else:
                    verdict = "FAIL"
                    failures.append(
                        f"{cfg}: host crossings regressed {bhc} -> {chc} "
                        "(fused plan lost device residency)")
        elif bh is not None and ch is None:
            warnings.append(f"{cfg}: baseline recorded host_crossings but "
                            "candidate did not (residency telemetry dropped)")
        # realtime delta-upload economics (q11r — realtime/device_plane.py
        # records the bytes uploaded by the first query, by the first
        # query after appending ~1% more rows, and by a warm repeat on an
        # unchanged generation). Two candidate-ONLY invariants need no
        # baseline and are plan properties with zero noise:
        #   delta >= full  — the incremental upload path is gone (every
        #                    query re-ships the whole snapshot);
        #   warm > 0       — the plane-resident fast path re-uploaded on
        #                    an unchanged generation.
        # Both fail even across platforms (upload bytes measure the plan,
        # not the machine). Baseline-relative growth uses the same ratio +
        # 4096-byte-floor rule as shuffled bytes.
        cfb = c.get("rt_full_bytes")
        cdb = c.get("rt_delta_bytes")
        if cfb is not None and cdb is not None:
            cfbi, cdbi = int(cfb), int(cdb)
            row.update({"candidateRtFullBytes": cfbi,
                        "candidateRtDeltaBytes": cdbi})
            if cfbi > 0 and cdbi >= cfbi:
                verdict = "FAIL"
                failures.append(
                    f"{cfg}: realtime delta upload ({cdbi}B) reached "
                    f"full-snapshot size ({cfbi}B) — incremental upload "
                    "path lost")
        cwb = c.get("rt_warm_bytes")
        if cwb is not None and int(cwb) > 0:
            verdict = "FAIL"
            failures.append(
                f"{cfg}: warm repeat on an unchanged generation uploaded "
                f"{int(cwb)}B (plane-resident fast path must upload 0)")
        bdb = b.get("rt_delta_bytes")
        if bdb is not None and cdb is not None:
            bdbi = int(bdb)
            delta_ratio = (int(cdb) / bdbi) if bdbi > 0 else float("inf")
            row.update({"baselineRtDeltaBytes": bdbi,
                        "rtDeltaBytesRatio": round(delta_ratio, 4)
                        if bdbi > 0 else None})
            if int(cdb) > bdbi * (1.0 + threshold) \
                    and int(cdb) - bdbi >= 4096:
                if cross_platform:
                    if verdict == "PASS":
                        verdict = "WARN"
                    warnings.append(
                        f"{cfg}: realtime delta bytes {bdbi} -> {int(cdb)} "
                        "across platforms")
                else:
                    verdict = "FAIL"
                    failures.append(
                        f"{cfg}: realtime delta bytes regressed {bdbi} -> "
                        f"{int(cdb)} ({(delta_ratio - 1) * 100:.1f}% more, "
                        f"threshold {threshold * 100:.0f}%)")
        elif bdb is not None and cdb is None:
            warnings.append(f"{cfg}: baseline recorded rt_delta_bytes but "
                            "candidate did not (delta telemetry dropped)")
        # tiered-storage round (cold-start vs warm-resident p50): compared
        # only when BOTH rounds measured it, same missing-side rule as
        # mesh. cold_p50_s times the first-query lazy fetch path;
        # warm_p50_s times the resident path, so a warm regression is a
        # hot-path regression no cold-fetch noise can excuse. A
        # warm_match flip is a correctness regression and always fails.
        for key, match_key, label in (
                ("cold_p50_s", None, "cold"),
                ("warm_p50_s", "warm_match", "warm")):
            bt = b.get(key)
            ct = c.get(key)
            if bt is None and ct is None:
                continue
            if bt is not None and ct is None:
                warnings.append(
                    f"{cfg}: baseline measured a {label} tiered round but "
                    f"candidate did not (tiered coverage dropped)")
                continue
            if bt is None:
                continue
            btp, ctp = float(bt), float(ct)
            t_ratio = (ctp / btp) if btp > 0 else float("inf")
            t_delta_ms = (ctp - btp) * 1000.0
            camel = "Cold" if label == "cold" else "Warm"
            row.update({f"baseline{camel}P50s": round(btp, 6),
                        f"candidate{camel}P50s": round(ctp, 6),
                        f"{label}Ratio": round(t_ratio, 4)})
            if match_key and b.get(match_key) is True \
                    and c.get(match_key) is False:
                verdict = "FAIL"
                failures.append(
                    f"{cfg}: {match_key} flipped true -> false "
                    "(tiered-storage correctness regression)")
            elif btp > 0 and t_ratio > 1.0 + threshold \
                    and t_delta_ms >= min_abs_ms:
                if timing_noise:
                    if verdict == "PASS":
                        verdict = "WARN"
                    warnings.append(
                        f"{cfg}: {label} p50 {btp:.4f}s -> {ctp:.4f}s "
                        f"({(t_ratio - 1) * 100:.1f}% slower) across "
                        f"{noise_label}")
                else:
                    verdict = "FAIL"
                    failures.append(
                        f"{cfg}: {label} p50 regressed {btp:.4f}s -> "
                        f"{ctp:.4f}s ({(t_ratio - 1) * 100:.1f}% slower, "
                        f"threshold {threshold * 100:.0f}%)")
        row["verdict"] = verdict
        rows.append(row)
    return {"pass": not failures, "threshold": threshold,
            "minAbsMs": min_abs_ms, "configs": len(base_cfg),
            "runnerShapeDiff": shape_diff,
            "failures": failures, "warnings": warnings, "rows": rows}


def _render_table(report: dict) -> str:
    lines = [f"{'config':<24} {'base p50':>12} {'cand p50':>12} "
             f"{'ratio':>7} {'verdict':>8}"]
    for r in report["rows"]:
        lines.append(
            f"{r['config']:<24} "
            f"{r.get('baselineP50s', float('nan')):>12.4f} "
            f"{r.get('candidateP50s', float('nan')):>12.4f} "
            f"{r.get('ratio', float('nan')):>7.3f} "
            f"{r['verdict']:>8}")
    for w in report["warnings"]:
        lines.append(f"WARN: {w}")
    for f in report["failures"]:
        lines.append(f"FAIL: {f}")
    lines.append("GATE: " + ("PASS" if report["pass"] else "FAIL"))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bench_gate",
        description="fail when a bench round regressed vs a baseline")
    ap.add_argument("baseline", help="baseline BENCH_*.json")
    ap.add_argument("candidate", help="candidate BENCH_*.json")
    ap.add_argument("--threshold", type=float, default=0.25,
                    help="p50 ratio slack before failing (default 0.25)")
    ap.add_argument("--min-abs-ms", type=float, default=2.0,
                    help="ignore regressions smaller than this many ms")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report instead of a table")
    args = ap.parse_args(argv)
    try:
        baseline = load_round(args.baseline)
        candidate = load_round(args.candidate)
    except (OSError, ValueError) as e:
        print(f"bench_gate: {e}", file=sys.stderr)
        return 2
    report = compare(baseline, candidate, threshold=args.threshold,
                     min_abs_ms=args.min_abs_ms)
    print(json.dumps(report, indent=2) if args.json
          else _render_table(report))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
