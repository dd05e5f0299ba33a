"""The decode's dispatch on a CUDA card, from the host's side.

A batch of bench.py's 8 synthetic lengths (foldcomp_tpu_torch.verify's
corpus, entries drawn with a fixed seed) is packed three ways: the full
wire with the auto rule's width classes, the full wire as one class, and
the bb wire. For each form, one JSON line:

- `off`, `recording`: the host's wall time of one
  codec.batch._seg_decode_arrays call with the card's queue empty (a
  synchronize before each call), the tracer off and on in turns (median
  and quartiles, us);
- `spans_median_us`: with the tracer on, the median of each child span of
  decode.dispatch, and `glue`: the dispatch less decode.k1, k2 and k3;
- `device_ms`: the card's time a call (CUDA events, 20 calls) of the
  kernel inputs and the lane order of every class, by torch's operations
  (class_prep and lane_order a class, `glue`) and, where the checkout has
  it, by k0 (fused_decode.prep, `k0`), in turns;
- `synchronizes`: the stream synchronizes one call makes, counted under
  torch.cuda.set_sync_debug_mode("warn"), and where "error" first raises.

Run from the root of the checkout to measure (this one, or an unpacked
copy of another commit, which is imported from the working directory):

    python3 <path>/tools/dispatch_probe.py [--entries 8192] [--calls 80]
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

LENGTHS = (120, 200, 280, 360, 480, 640, 840, 1080)
SPANS = ("decode.k1", "decode.k2", "decode.k3")


def cuda_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_walls(torch, tracing, B, ta, calls):
    """Wall time of one dispatch with the queue empty, tracer off and on
    in turns, and the dispatch's child spans when on."""
    for _ in range(3):
        B._seg_decode_arrays(ta)
    walls = {False: [], True: []}
    spans = {}
    for it in range(calls):
        rec = bool(it % 2)
        torch.cuda.synchronize()
        if rec:
            tracing.enable()
        t0 = time.perf_counter()
        out = B._seg_decode_arrays(ta)
        walls[rec].append((time.perf_counter() - t0) * 1e6)
        if rec:
            tracing.disable()
            s = tracing.last()
            (d,) = s.named("decode.dispatch")
            kids = {}
            for x in s.spans:
                if x.parent == d.id:
                    kids[x.name] = kids.get(x.name, 0) + x.seconds * 1e6
            kids["glue"] = d.seconds * 1e6 - sum(
                v for k, v in kids.items() if k in SPANS)
            for k, v in kids.items():
                spans.setdefault(k, []).append(v)
        del out
    torch.cuda.synchronize()
    res = {("recording" if r else "off"): {
        "median_us": statistics.median(w),
        "quartiles_us": statistics.quantiles(w, n=4)}
        for r, w in walls.items()}
    res["spans_median_us"] = {k: statistics.median(v)
                              for k, v in spans.items()}
    return res


def synchronizes(torch, B, ta):
    """Synchronizes one dispatch makes ("warn"), and the first one's
    place ("error")."""
    B._seg_decode_arrays(ta)
    torch.cuda.synchronize()
    res = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            B._seg_decode_arrays(ta)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    res["warned"] = sum("synchroniz" in str(x.message) for x in w)
    torch.cuda.set_sync_debug_mode("error")
    try:
        B._seg_decode_arrays(ta)
        res["raised"] = None
    except RuntimeError as e:
        tb = traceback.extract_tb(e.__traceback__)
        res["raised"] = [f"{f.filename.split('/')[-1]}:{f.lineno} "
                         f"{f.name}: {f.line}" for f in tb[-2:]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return res


def class_args(ta):
    """One (seg_records, mins_lane, cont_lane, sc_codes_seg, fwd9, rev9,
    seg_m) tuple a class of a tensor dict."""
    if "classes" in ta:
        c = ta["classes"]
        return list(zip(*(c[k] for k in ("recs", "mins", "cont", "sct",
                                         "fwd", "rev", "segm"))))
    return [tuple(ta[k] for k in ("seg_records", "mins_lane", "cont_lane",
                                  "sc_codes_seg", "fwd9", "rev9", "seg_m"))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--entries", type=int, default=8192)
    ap.add_argument("--calls", type=int, default=80)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from foldcomp_tpu_torch import tracing, verify
    from foldcomp_tpu_torch.codec import batch as B
    from foldcomp_tpu_torch.kernels import fused_decode as FD

    if not torch.cuda.is_available():
        print("dispatch_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[:1]
    uniq = verify.synthetic_corpus(LENGTHS)
    keys = sorted(uniq)
    rng = np.random.default_rng(0)
    fczs = [uniq[keys[int(i)]] for i in rng.integers(0, len(keys),
                                                     args.entries)]
    forms = {"classed": (False, "auto"), "single": (False, "0"),
             "bb": (True, "0")}
    for name, (bb, wclass) in forms.items():
        ta = B.arrays_to_torch(
            B.pack_decode_wire(fczs, bb, wclass=wclass)[0], "cuda")
        classes = class_args(ta)
        res = host_walls(torch, tracing, B, ta, args.calls)
        # a checkout whose k0 has a bb mode holds a bb pack without its
        # side-chain codes, and prepares it in that mode
        wire = {"wire": "bb" if bb else "full"} \
            if "prep_bb" in FD.launch_counts() else {}

        def glue():
            for c in classes:
                FD.lane_order(FD.class_prep(*c, **wire)["tat"])

        timed = [("glue", glue)]
        if hasattr(FD, "prep"):
            timed.append(("k0", lambda: FD.prep(classes, **wire)))
        runs = {}
        for k, fn in timed + timed[::-1]:
            runs.setdefault(k, []).append(cuda_ms(torch, fn))
        res["device_ms"] = runs
        res["synchronizes"] = synchronizes(torch, B, ta)
        print(json.dumps({"dispatch_probe": name, "checkout": os.getcwd(),
                          "card": card, "torch": torch.__version__,
                          "entries": args.entries, "calls": args.calls,
                          "classes": len(classes),
                          "lanes": [int(c[0].shape[2]) for c in classes],
                          **res}), flush=True)
        del ta
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
