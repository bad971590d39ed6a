"""Certify a fast operating point against the exact path: a paired
comparison of two run_quality JSONs over the same held-out windows and
per-window draws.

  python -m storygen_tpu_torch.scripts.compare_quality \\
      <root>/quality_exact_s500.json <root>/quality_dpm25_s500.json

For each metric the fast pass's distribution is held against the exact
pass's p10-p90 band, and window by window (mean delta against the exact
path's own window-to-window std). The rule: CLIP-I's p50 inside the exact
band, its mean within one exact std, and CLIP-FID not worse by more than
10% of the exact path's. numpy and json only; the same comparison as the
JAX package's scripts/compare_quality.py.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def compare(exact: dict, fast: dict) -> dict:
    out = {}
    for key in ("clip_i", "clip_t", "pickscore"):
        ed, fd = exact[f"{key}_dist"], fast[f"{key}_dist"]
        row = {
            "exact_mean": ed["mean"], "fast_mean": fd["mean"],
            "exact_band": [ed["p10"], ed["p90"]],
            "fast_p50": fd["p50"],
            "p50_in_exact_band": ed["p10"] <= fd["p50"] <= ed["p90"],
            "mean_delta": fd["mean"] - ed["mean"],
            "mean_delta_over_exact_std":
                (fd["mean"] - ed["mean"]) / max(ed["std"], 1e-12),
        }
        pw_e = exact.get("per_window", {}).get(key)
        pw_f = fast.get("per_window", {}).get(key)
        if pw_e and pw_f and len(pw_e) == len(pw_f):
            d = np.asarray(pw_f, np.float64) - np.asarray(pw_e, np.float64)
            row["paired"] = {
                "mean": float(d.mean()), "std": float(d.std()),
                "p10": float(np.percentile(d, 10)),
                "p90": float(np.percentile(d, 90)),
                "frac_within_exact_band": float(np.mean(
                    (np.asarray(pw_f) >= ed["p10"])
                    & (np.asarray(pw_f) <= ed["p90"]))),
            }
        out[key] = row
    out["clip_fid"] = {"exact": exact["clip_fid"], "fast": fast["clip_fid"],
                       "delta": fast["clip_fid"] - exact["clip_fid"]}
    # CLIP-I is the conditioning metric this corpus can measure (CLIP-T is
    # noise under random-init towers)
    ci = out["clip_i"]
    out["certified"] = bool(
        ci["p50_in_exact_band"]
        and abs(ci["mean_delta_over_exact_std"]) <= 1.0
        and out["clip_fid"]["delta"] <= 0.1 * max(exact["clip_fid"], 1e-12))
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("exact", help="the exact pass's run_quality JSON")
    ap.add_argument("fast", help="the fast pass's run_quality JSON")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Print (and return) the comparison with both passes' settings."""
    args = parse_args(argv)
    exact, fast = load(args.exact), load(args.fast)
    res = compare(exact, fast)
    for name, run in (("exact_config", exact), ("fast_config", fast)):
        res[name] = {k: run.get(k) for k in
                     ("sampler", "num_inference_steps",
                      "ref_feature_interval", "checkpoint")}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
