#!/usr/bin/env python3
"""What the port's tree and bits kernels (csrc/rac.cu decode_tree_kernel
and decode_bits_kernel, behind ops/rac.py decode_tree_multi and
decode_bits_multi) cost, and an A/B of their builds, on one CUDA card.

Inputs are chip_smoke.py's seeded lanes ("mixed": 64 lanes of 1,024
bytes; bits: 2,048 bools a lane under probabilities 1-255; tree: 512
symbols of the intra-mode tree a lane under probabilities 40-219) and
two forms of them: "equal", every lane lane 0's bytes and probabilities,
so that no lane of a warp waits on another; "p128", the equal lanes
under probability 128 everywhere, which renormalizes at most one bit a
bool. A variant (";"-separated) is "+"-joined items: "@PATH" another
source of csrc/rac.cu than the one as it stands, such as a parent
commit's unpacked into a gitignored directory; "NAME=VALUE" rewrites
`constexpr int NAME = VALUE;` (kStreamLanes, the lanes a block); "cap"
launches the tree kernel's instance with the depth cap whatever the
tree (CAP, its only edit); "" is the source as it stands. A source with
the entry points before the cycles argument is timed as it stands, and
a second build of it, with a clock64 read around each lane's loop
(CLOCK, its only edits), gives its lanes' cycles. For each
build in turns (a b c c b a), every input is held to the plain version
and timed on the card's clock (chip_smoke.device_ms, --reps launches),
its call under CUDA events, with each lane's cycles; per input, the
longest lane's chain alone (chip_smoke.stream_chain) and the clock that
chain ran at; each turn, the launch floor. Prints one JSON object and
writes it to --out.

    python3 tools/rac_streams_ab_torch.py [--reps 50]
        [--out rac_streams_ab.json] [--inputs "mixed;equal;p128"]
        [--variants ";@build/old/rac.cu;cap;kStreamLanes=8"]
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("tree", "bits")
# the edits that put a clock64 read around each lane's loop of the
# earlier kernels (one thread a lane, `s` its index) and read the cycles
# back: rac_read_cycles(dst, n, stream) copies n of them into dst
CLOCK = [
    ("namespace {\n", "namespace {\n\n__device__ long long g_cycles[1 << 16];\n"),
    ("  for (int i = 0; i < K; ++i) o[i] = rac.get(p[i]);\n}",
     "  const long long t0 = clock64();\n"
     "  for (int i = 0; i < K; ++i) o[i] = rac.get(p[i]);\n"
     "  g_cycles[s] = clock64() - t0;\n}"),
    ("  const uint8_t* p = probs + static_cast<int64_t>(s) * NN;\n"
     "  for (int i = 0; i < k; ++i) {",
     "  const uint8_t* p = probs + static_cast<int64_t>(s) * NN;\n"
     "  const long long t0 = clock64();\n"
     "  for (int i = 0; i < k; ++i) {"),
    ("    out[static_cast<int64_t>(s) * k + i] = val;\n  }\n}",
     "    out[static_cast<int64_t>(s) * k + i] = val;\n  }\n"
     "  g_cycles[s] = clock64() - t0;\n}"),
    ('}  // extern "C"',
     "int rac_read_cycles(long long* dst, int n, cudaStream_t stream) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbolAsync(\n"
     "      dst, g_cycles, n * sizeof(long long), 0,\n"
     "      cudaMemcpyDeviceToDevice, stream));\n}\n\n"
     '}  // extern "C"'),
]
# the edit that makes rac_decode_tree launch the capped instance
CAP = ("  auto kernel = cycles ? (capped ?",
       "  capped = 1;\n  auto kernel = cycles ? (capped ?")


def _source(v):
    """The source text of variant v."""
    from ffmpeg_hybrid_tpu_torch import _build
    items = v.split("+") if v else []
    paths = [t[1:] for t in items if t.startswith("@")]
    path = os.path.join(ROOT, paths[0]) if paths else \
        os.path.join(_build.CSRC_DIR, "rac.cu")
    with open(path) as f:
        text = f.read()
    for item in items:
        if item == "cap":
            if text.count(CAP[0]) != 1:
                raise RuntimeError(f"{path}: cannot apply {item!r}")
            text = text.replace(*CAP)
        elif not item.startswith("@"):
            name, value = item.split("=", 1)
            text, n = re.subn(rf"constexpr int {name} = [^;]+;",
                              f"constexpr int {name} = {value};", text)
            if n != 1:
                raise RuntimeError(f"{path} has no constant {name}")
    return text


def _earlier(src):
    """Whether a source has the entry points before the cycles argument."""
    return not re.search(r"int rac_decode_bits\([^)]*long long\* cycles",
                         src)


def _clocked(src):
    for a, b in CLOCK:
        if src.count(a) != 1:
            raise RuntimeError(f"cannot put the clock reads in: {a[:40]!r}")
        src = src.replace(a, b, 1)
    return src


def build(variants):
    """{source text: (library, ptxas lines)} for every distinct source
    (and the clocked build of each earlier one), nvcc started for all at
    once."""
    from ffmpeg_hybrid_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    texts = []
    for v in variants:
        src = _source(v)
        for t in ((src, _clocked(src)) if _earlier(src) else (src,)):
            if t not in texts:
                texts.append(t)
    procs = []
    for i, text in enumerate(texts):
        stem = os.path.join(_build.BUILD_DIR, f"rac_streams_ab_{i}")
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs.append((text, stem, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", stem + ".so", stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for text, stem, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of {stem}.cu failed:\n{log}")
        libs[text] = (ctypes.CDLL(stem + ".so"),
                      [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Compiling entry" in ln])
    return libs


# the earlier entry points' arguments, the stream last
EARLIER = {"rac_decode_tree": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
           + [ctypes.c_void_p] * 2,
           "rac_decode_bits": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int]
           + [ctypes.c_void_p] * 2,
           "rac_read_cycles": [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p]}


def _ptr(torch, a):
    return a.data_ptr() if torch.is_tensor(a) else a


def earlier_call(torch, lib, clock_lib, kind, inp):
    """(fn, cycles_fn) of an earlier source: fn() launches its kernel on
    the input and returns the output; cycles_fn() launches the clocked
    build and returns each lane's cycles."""
    data, probs, _tree, k = inp["dev"]
    tree = inp["tree_dev"]
    S, L = data.shape
    out = torch.empty(inp["want"].shape, dtype=torch.int32,
                      device=data.device)

    for lb in (lib, clock_lib):
        for name, argtypes in EARLIER.items():
            if hasattr(lb, name):
                getattr(lb, name).argtypes = argtypes
                getattr(lb, name).restype = ctypes.c_int

    def launch(lb):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "tree":
            rc = lb.rac_decode_tree(
                _ptr(torch, data), S, L, _ptr(torch, probs), tree.shape[0],
                _ptr(torch, tree), k, 12, _ptr(torch, out), stream)
        else:
            rc = lb.rac_decode_bits(_ptr(torch, data), S, L,
                                    _ptr(torch, probs), probs.shape[1],
                                    _ptr(torch, out), stream)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        return out

    def cycles():
        launch(clock_lib)
        cyc = torch.zeros(S, dtype=torch.int64, device=data.device)
        rc = clock_lib.rac_read_cycles(
            _ptr(torch, cyc), S, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        return cyc
    return lambda: launch(lib), cycles


def current_call(torch, lib, kind, inp):
    """(fn, cycles_fn) of a source with the current interface, through
    the wrappers' launchers."""
    from ffmpeg_hybrid_tpu_torch import _build
    from ffmpeg_hybrid_tpu_torch.ops import rac
    for name, argtypes in rac._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    data, probs, tree, k = inp["dev"]
    name = f"decode_{kind}_multi"

    def fn():
        _build._LIBS["rac.cu"] = lib
        if kind == "tree":
            return rac._launch_tree(data, probs, tree, k, 12, False)[0]
        return rac._launch_bits(data, probs, False)[0]

    def cycles():
        _build._LIBS["rac.cu"] = lib
        args = (tree, k) if kind == "tree" else ()
        return rac.stream_cycles(name, data, probs, *args)[1]
    return fn, cycles


def make_inputs(torch, np, cs, names):
    """{(kind, input): {dev, tree_dev, want, bools, longest, chain}}: the
    lanes on the card (data, probs, the host tree, K), the tree on the
    card, the plain version's outputs, the spec decoder's bools a lane,
    the longest lane, and its chain alone."""
    from ffmpeg_hybrid_tpu_torch.ops import rac
    out = {}
    for kind in KINDS:
        data0, probs0, tree, K = cs.stream_lanes(np, kind)
        for name in names:
            data, probs = data0, probs0
            if name in ("equal", "p128"):
                data = np.repeat(data[:1], len(data), 0)
                probs = np.repeat(probs[:1], len(probs), 0)
            if name == "p128":
                probs = np.full_like(probs, 128)
            extra = () if tree is None else (tree, K)
            bools = cs.spec_stream(np, data, probs, *extra)[1]
            d = torch.as_tensor(data, device="cuda")
            p = torch.as_tensor(probs, device="cuda")
            plain = getattr(rac, f"decode_{kind}_multi_plain")
            want = plain(d, p, *extra)
            longest = int(np.argmax(bools))
            cpb, hz = cs.stream_chain(rac, torch, np, data[longest],
                                      probs[longest, :8], bools[longest])
            print(f"input {kind} {name}: {max(bools)} bools the longest "
                  f"lane, its chain alone {cpb:.2f} cycles a bool",
                  file=sys.stderr, flush=True)
            out[kind, name] = {
                "dev": (d, p, tree, K),
                "tree_dev": None if tree is None else
                torch.as_tensor(tree, device="cuda"),
                "want": want, "bools": bools, "longest": longest,
                "chain": {"cycles_per_bool": cpb, "clock_hz": hz}}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=";cap;kStreamLanes=8;"
                    "kStreamLanes=32",
                    help="';'-separated builds of csrc/rac.cu")
    ap.add_argument("--inputs", default="mixed;equal;p128")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import faulthandler
    faulthandler.enable()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("rac_streams_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ffmpeg_hybrid_tpu_torch import _build
    variants = args.variants.split(";")
    names = args.inputs.split(";")
    empty_build = cs.start_empty_build()
    libs = build(variants)
    empty = cs.load_empty(empty_build)
    inputs = make_inputs(torch, np, cs, names)
    runs = {v or "as it stands": {} for v in variants}
    floors = []
    for turn in (0, 1):
        floors.append(cs.launch_floor_ms(torch, empty, args.reps))
        for v in variants if turn == 0 else variants[::-1]:
            src = _source(v)
            lib = libs[src][0]
            for (kind, name), inp in inputs.items():
                print(f"turn {turn}: '{v}' on {kind} {name}", file=sys.stderr,
                      flush=True)
                if _earlier(src):
                    fn, cyc_fn = earlier_call(torch, lib,
                                              libs[_clocked(src)][0], kind,
                                              inp)
                else:
                    fn, cyc_fn = current_call(torch, lib, kind, inp)
                if not torch.equal(fn(), inp["want"]):
                    raise RuntimeError(f"variant '{v}' on {kind} {name}: "
                                       "kernel != plain")
                ms, ops = cs.device_ms(torch, fn, args.reps,
                                       (f"decode_{kind}_kernel",))
                cyc = cyc_fn().cpu().numpy()
                if (cyc <= 0).any():
                    raise RuntimeError(f"variant '{v}': no cycles read")
                bools = np.asarray(inp["bools"])
                per = cyc / bools
                runs[v or "as it stands"].setdefault(
                    f"{kind} {name}", []).append({
                        "ms": ms, "device_ops": ops,
                        "call_ms": cs.cuda_ms(fn, 20),
                        "cycles_max": int(cyc.max()),
                        "cycles_per_bool_longest":
                            float(per[inp["longest"]]),
                        "cycles_per_bool_mean": float(per.mean()),
                        "cycles_per_bool_max": float(per.max())})
        floors.append(cs.launch_floor_ms(torch, empty, args.reps))
    _build._LIBS.pop("rac.cu", None)
    report = {
        "card": cs.card_line(), "torch": torch.__version__,
        "launch_floor_ms": floors,
        "inputs": {f"{k} {n}": {"lanes": len(i["bools"]),
                                "bools_longest": int(max(i["bools"])),
                                "bools": int(sum(i["bools"])),
                                "chain_alone": i["chain"]}
                   for (k, n), i in inputs.items()},
        "ptxas": {v or "as it stands": libs[_source(v)][1]
                  for v in variants},
        "runs": runs}
    print(json.dumps({"rac_streams_ab": report}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
