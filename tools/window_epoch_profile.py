"""Time the window-step epoch at the ML-1M headline shape on one GPU and
list its top device operations from one `jax.profiler` trace.

    python tools/window_epoch_profile.py [--epochs 20] [--repeats 5]
                                         [--trace-dir DIR]

The shape is chip_smoke.py's phase 2 (6,040 x 3,706, ~748k rows, f=20,
WARP max_samples=20, invscaling). After a warm-up fit that compiles, each
repeat times ``fit_partial(epochs=E)`` end to end (the fit syncs on its
last log-likelihood), so seconds per epoch include the host's dispatch.
Then three epochs run under the profiler; the device events of the trace
are summed per operation name, and the device's busy share of the traced
window is the union of its operation intervals over the window.

Needs a GPU: it refuses to time anything on another backend.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]


def device_op_summary(xplane_path, top=15):
    """(top ops by summed device time, busy share of the window) from an
    ``.xplane.pb`` trace: per-name sums over the GPU planes' "XLA Ops"
    lines (every line of the plane when it has none)."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    sums, counts, spans = {}, {}, []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        for ln in ops:
            for ev in ln.events:
                sums[ev.name] = sums.get(ev.name, 0) + ev.duration_ns
                counts[ev.name] = counts.get(ev.name, 0) + 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        return [], float("nan")
    spans.sort()
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    total = sum(sums.values())
    rows = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return ([{"op": k, "ms": v / 1e6, "count": counts[k],
              "share": v / total} for k, v in rows],
            busy / max(window, 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--trace-dir", default=os.path.join(REPO, ".profile",
                                                        "window_trace"),
                    help="where the trace and summary.json go")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("window_epoch_profile: needs a GPU, found "
                         f"{jax.devices()[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    from parity_common import make_latent_dataset
    from rankfm_tpu import RankFM

    train, _ = make_latent_dataset(np.random.default_rng(1492), n_users=6040,
                                   n_items=3706, per_user=165, sharp=1.2)
    model = RankFM(factors=20, loss="warp", max_samples=20, alpha=0.01,
                   sigma=0.1, learning_rate=0.1,
                   learning_schedule="invscaling", seed=1492)
    t0 = time.perf_counter()
    model.fit(train, epochs=1)
    print(f"warm-up fit (compile included): {time.perf_counter() - t0:.3f} s;"
          f" plan {model.last_fit_plan_}", flush=True)
    assert model.last_fit_plan_.step_kind == "window"

    per_epoch = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        model.fit_partial(train, epochs=args.epochs)
        per_epoch.append((time.perf_counter() - t0) / args.epochs)
    print(f"steady seconds per epoch over {args.repeats} x {args.epochs} "
          f"epochs: min {min(per_epoch):.6f} median "
          f"{float(np.median(per_epoch)):.6f} all {per_epoch}", flush=True)
    print(f"interactions/s at the median: "
          f"{len(train) / float(np.median(per_epoch)):.1f}", flush=True)

    os.makedirs(args.trace_dir, exist_ok=True)
    with jax.profiler.trace(args.trace_dir):
        model.fit_partial(train, epochs=3)
    paths = sorted(glob.glob(os.path.join(args.trace_dir, "**",
                                          "*.xplane.pb"), recursive=True))
    top, busy = device_op_summary(paths[-1])
    print(f"device busy share of the traced window: {busy:.4f}")
    print("top device operations (3 traced epochs):")
    for r in top:
        print(f"  {r['ms']:10.3f} ms  {r['share']:6.1%}  x{r['count']:<6d} "
              f"{r['op']}")
    out = {"card": card, "seconds_per_epoch": per_epoch,
           "rows": int(len(train)), "busy_share": busy, "top_ops": top}
    with open(os.path.join(args.trace_dir, "summary.json"), "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
