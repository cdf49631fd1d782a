#!/usr/bin/env python3
"""Where a replay ticket's time goes on one CUDA card: csrc/lpf_replay.cu
built with a timestamp (%globaltimer, ns) taken by thread 0 of each
ticket's block at six points (the ticket taken; its waits done; its
window copied; its levels run; its write-back issued; its flag
released), on the inputs of tools/lpf_replay_ab_torch.py.

For each input, with its records and with every record a no-op
(Replay.idle, the chain alone): the launch's span, each section's median
over the tickets, and the critical chain: from the ticket that finished
last, back through the wait that released it last, each step's sections
summed and the flag's latency (its release to the waiter's waits done),
each divided by the chain's length (its waves). The instrumented source
is made from the repository's by inserting the stamps at the ticket's
numbered steps (the comments "// 2. the rest of the window" and so on)
into a copy in the build directory; nothing in the repository changes. Prints one JSON object and writes it
to --out.

    python3 tools/lpf_replay_sections_torch.py [--out sections.json]
"""
import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ("wait", "copy", "levels", "writeback", "release")

# (text in the source, the stamp put after its first line)
STAMPS = (
    ("  const int warp = tid >> 5, lane = tid & 31;\n",
     "  unsigned long long* dbg = g_dbg + static_cast<size_t>(k) * 8;\n"
     "  if (tid == 0) dbg[0] = gtime();\n"),
    ("  __syncthreads();\n  // 2. the rest of the window",
     "  if (tid == 0) dbg[1] = gtime();\n"),
    ("  __syncthreads();\n  // 3. the levels",
     "  if (tid == 0) dbg[2] = gtime();\n"),
    ("  __syncthreads();\n  // 4. the write-back",
     "  if (tid == 0) dbg[3] = gtime();\n"),
    ("  __syncthreads();\n  if (tid == 0) release(a.flags + k, a.epoch);\n",
     "  if (tid == 0) dbg[4] = gtime();\n"),
    ("  if (tid == 0) release(a.flags + k, a.epoch);\n}",
     "  if (tid == 0) dbg[5] = gtime();\n"),
)
TIMER = ("__device__ unsigned long long* g_dbg;\n\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n\n")
ENTRY = ("\nint set_debug(unsigned long long* p) {\n"
         "  return static_cast<int>(cudaMemcpyToSymbol(g_dbg, &p, "
         "sizeof(p)));\n}\n")


def instrumented(src):
    """The source with the timer, the stamps and an entry
    set_debug(pointer): the stamps' array, [tickets][8] ns."""
    for text, _stamp in STAMPS:
        if src.count(text) != 1:
            raise RuntimeError(f"the source has no single place {text!r}")
    for text, stamp in STAMPS:
        line, rest = text.split("\n", 1)
        src = src.replace(text, line + "\n" + stamp + rest)
    src = src.replace("namespace {\n", TIMER + "namespace {\n", 1)
    return src.replace('extern "C" {\n', 'extern "C" {\n' + ENTRY, 1)


def analyse(np, d, tickets):
    """The sections of one launch's stamps d [nt, 8] (ns)."""
    t0 = d[:, 0].min()
    out = {"span_us": float((d[:, 5].max() - t0) / 1e3),
           "tickets": int(len(d)),
           "levels_median": float(np.median(tickets[:, 2])),
           "median_us": {n: float(np.median(d[:, j + 1] - d[:, j]) / 1e3)
                         for j, n in enumerate(SECTIONS)}}
    k, chain = int(np.argmax(d[:, 5])), []
    while True:
        chain.append(k)
        deps = [x for x in tickets[k, 4:8] if x >= 0]
        if not deps:
            break
        k = max(deps, key=lambda x: d[x, 5])
    ch = d[chain]
    n = len(chain)
    out["chain"] = n
    out["chain_us_a_step"] = {
        s: float((ch[:, j + 1] - ch[:, j]).sum() / 1e3 / n)
        for j, s in enumerate(SECTIONS) if s != "wait"}
    out["chain_us_a_step"]["flag"] = float(
        sum(ch[i, 1] - ch[i + 1, 5] for i in range(n - 1)) / 1e3 / n)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lpf_replay_sections_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import chip_smoke as cs
    import lpf_replay_ab_torch as ab
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import lpf_replay as LR
    _build.build_all()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "lpf_replay_sections.cu")
    with open(os.path.join(_build.CSRC_DIR, "lpf_replay.cu")) as f:
        src = instrumented(f.read())
    with open(path, "w") as f:
        f.write(src)
    libs = ab.build([("lpf_replay.cu", "@" + os.path.relpath(path, ROOT))])
    (lib, _first, ptxas), = libs.values()
    lib.set_debug.argtypes = [ctypes.c_void_p]
    lib.set_debug.restype = ctypes.c_int
    cases = ab.replay_inputs(np, torch, cs)
    ab.install(lib, "lpf_replay.cu", LR._SIGNATURES)
    report = {"card": cs.card_line(), "ptxas": ptxas, "inputs": {}}
    for key, buf, steps, wreal, bpp, sb, halo in cases:
        rp = LR.Replay(steps, buf.shape, sb, wreal, LR.HALO if halo else 0,
                       halo)
        for label, r in (("records", rp), ("no-ops", rp.idle())):
            dbg = torch.zeros(rp.ntickets * 8 + 8, dtype=torch.int64,
                              device="cuda")
            if lib.set_debug(dbg.data_ptr()):
                raise RuntimeError("set_debug failed")
            work = buf.clone()
            for _ in range(3):   # the last launch's stamps stay
                work.copy_(buf)
                if halo:
                    LR.lf_scan_sharded(work, r, wreal, bpp, sb)
                else:
                    LR._launch(work, r, bpp)
            torch.cuda.synchronize()
            d = dbg.cpu().numpy()[:rp.ntickets * 8].reshape(-1, 8)
            row = analyse(np, d.astype(np.int64), rp.parts["tickets"])
            report["inputs"][f"{key} {label}"] = row
            print(f"[sections] {key} {label}: span {row['span_us']:.1f} us,"
                  f" {row['chain']} steps of the chain, a step "
                  + ", ".join(f"{s} {v:.2f}" for s, v in
                              row["chain_us_a_step"].items()) + " us",
                  flush=True)
    _build._LIBS.pop("lpf_replay.cu", None)
    print(json.dumps({"lpf_replay_sections": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
