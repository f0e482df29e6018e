"""The Ozaki kernel's launch geometry, measured on one GPU.

    python3 -m madipm_tpu_torch.tools.tune_ozaki [--variant i8]
        [--const I8_STAGES=2,3,4 ...] [--slices 8]
        [--out madipm_tpu_torch/_build/tune_ozaki.json]

Builds ``csrc/ozaki.cu`` once per combination of the values given to its
integer constants (each ``constexpr int NAME = ...;`` line replaced in a
copy under ``madipm_tpu_torch/_build/tune/``; by default the source as it
is; one nvcc each, all started together, with ``-Xptxas -v``), then,
at each (B, m, n) that the Ozaki LP suite and the certificates launch and
in both directions, calls the entry point directly with every tile the
kernel takes, every split of the contraction into whole chunks and (int8)
every count of slice groups that gives the grid between SMS / 2 and 16 SMS
CTAs.  Each configuration is first held against the plain version
(``ops/ozaki.plain_contract`` on ``vector_operands``' slices: within
1e-15 K relative to rowmax|A| max|x|, and the kernel's own vector slices
bit-equal), then timed on the device from a CUDA graph of 20 calls (the
least of 5 replays).  Prints one line per configuration, marks the one
``ops/ozaki.plan`` picks, and writes every row as JSON.  It needs a CUDA
device and exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _cuda, ozaki

#: the (B, m, n) of the Ozaki LP suite (A, and A' through stored slices)
#: and of one certificate instance
SHAPES = ((8, 1024, 2048), (8, 2048, 1024), (1, 1024, 2048))
#: the card's bytes per second (NVIDIA's H100 SXM data sheet)
PEAK_BYTES = 3.35e12


def build(variant: str, consts: list) -> dict:
    """One library per combination of the constants' values ``consts``
    ([(name, [values])]): {label: (path, ptxas lines of the kernel)}."""
    src = (_cuda._CSRC / "ozaki.cu").read_text()
    for name, _ in consts:
        if len(re.findall(rf"constexpr int {name} = -?\d+;", src)) != 1:
            sys.exit(f"tune_ozaki: no single 'constexpr int {name}' line in ozaki.cu")
    root = _cuda._BUILD_DIR / "tune"
    root.mkdir(parents=True, exist_ok=True)
    flags = [*_cuda._NVCC_FLAGS, "-Xptxas", "-v"]
    procs = {}
    for values in itertools.product(*(vals for _, vals in consts)):
        label = ",".join(f"{name}={v}" for (name, _), v in zip(consts, values)) or "source"
        text = src
        for (name, _), v in zip(consts, values):
            text = re.sub(rf"constexpr int {name} = -?\d+;", f"constexpr int {name} = {v};", text)
        tag = f"{variant}_{len(procs)}"
        (root / f"ozaki_{tag}.cu").write_text(text)
        lib = root / f"libozaki_{tag}.so"
        procs[label] = (lib, subprocess.Popen([_cuda._nvcc(), *flags, "-o", str(lib), str(root / f"ozaki_{tag}.cu")],
                                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for k, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"tune_ozaki: nvcc failed at {k}:\n{err}")
        kernel = "i8_kernel" if variant == "i8" else "bf16_kernel"
        lines = err.splitlines()
        info = []
        for i, a in enumerate(lines):
            if kernel in a and "Compiling entry" in a:
                used = next((b for b in lines[i + 1:i + 6] if "Used" in b), "")
                info.append(f"{a.split(kernel)[-1].split(chr(39))[0]}: {used.split(':', 1)[-1].strip()}")
        out[k] = (lib, info)
    return out


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call: ``calls`` calls in one CUDA graph,
    each of ``reps`` replays between two events; the least of them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    del graph
    return best


def entry_fn(lib: Path, entry: str):
    fn = getattr(ctypes.CDLL(str(lib)), f"madipm_ozaki_{entry}")
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def configs(B, S, m, n, transposed, variant, sms):
    """(tile, split, groups) of every tile the kernel takes, every divisor
    split with spans within MAX_SPAN and every divisor count of slice
    groups (int8) whose grid has SMS / 2 to 16 SMS CTAs."""
    K, out_len = (m, n) if transposed else (n, m)
    chunks = K // ozaki.CHUNK
    for tile in ozaki.TILES[variant, transposed]:
        for split in range(1, chunks + 1):
            for groups in range(1, (S if variant == "i8" else 1) + 1):
                ctas = B * (out_len // tile) * split * groups
                if (chunks % split == 0 and S % groups == 0 and chunks // split <= ozaki.MAX_SPAN
                        and sms // 2 <= ctas <= 16 * sms):
                    yield tile, split, groups


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=("i8", "bf16"), default="i8")
    ap.add_argument("--const", action="append", default=[], metavar="NAME=V1,V2",
                    help="values of one integer constant of ozaki.cu to build and time")
    ap.add_argument("--slices", type=int, default=None, help="default: 8 for i8, 5 for bf16")
    ap.add_argument("--out", default=str(_cuda._BUILD_DIR / "tune_ozaki.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_ozaki: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    S = args.slices or (8 if args.variant == "i8" else 5)
    consts = [(c.split("=")[0], [int(v) for v in c.split("=")[1].split(",")]) for c in args.const]
    libs = build(args.variant, consts)
    for k, (_, info) in libs.items():
        print(f"{k}: ptxas " + "\n  ".join(info), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = []
    for B, m, n in SHAPES:
        A = torch.randn(B, m, n, generator=gen, device="cuda", dtype=torch.float64)
        A = A * (torch.rand(B, m, n, generator=gen, device="cuda") < 0.15)
        sm = ozaki.slice_any(A, args.variant, S)
        for transposed in (False, True):
            entry = f"{args.variant}_{'t' if transposed else 'fwd'}"
            K, out_len = (m, n) if transposed else (n, m)
            vec = torch.randn(B, K, generator=gen, device="cuda", dtype=torch.float64)
            vs, vscale = ozaki.vector_operands(entry, sm, vec)
            ref = ozaki.plain_contract(entry, sm, vs, vscale)
            rowmax = A.abs().amax(dim=-1)
            scale = (rowmax.amax(dim=-1, keepdim=True) if transposed else rowmax) * vec.abs().amax(-1, keepdim=True)
            nbytes = sm.slices.numel() * sm.slices.element_size() + B * K * 8 + B * m * 8 + B * out_len * 8
            bound = 1e3 * nbytes / PEAK_BYTES
            bmm = (lambda: torch.bmm(vec.unsqueeze(1), A).squeeze(1)) if transposed else \
                (lambda: torch.bmm(A, vec.unsqueeze(-1)).squeeze(-1))
            bmm_ms = graph_ms(bmm)
            chosen = ozaki.plan(B, S, m, n, transposed, sms, args.variant)
            print(f"{entry} at ({B}, {m}, {n}) S={S}: bound {bound:.4f} ms (bytes), torch.bmm {bmm_ms:.4f} ms; "
                  f"plan: tile {chosen.tile}, split {chosen.split}, groups {chosen.groups}", flush=True)
            for k, (path, _) in libs.items():
                fn = entry_fn(path, entry)
                for tile, split, groups in configs(B, S, m, n, transposed, args.variant, sms):
                    out = torch.empty(B, out_len, dtype=torch.float64, device="cuda")
                    work = torch.empty(B * split * groups * out_len + B, dtype=torch.float64, device="cuda")
                    ks = torch.empty_like(vs)
                    kscale = torch.empty_like(vscale)

                    def call(keep=False):
                        rc = fn(sm.slices.data_ptr(), sm.row_scale.data_ptr(), vec.data_ptr(), out.data_ptr(),
                                work.data_ptr(), ks.data_ptr() if keep else None,
                                kscale.data_ptr() if keep else None, B, S, m, n, tile, split, groups,
                                torch.cuda.current_stream().cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"{entry} tile {tile} split {split} groups {groups}: cudaError {rc}")

                    call(keep=True)
                    torch.cuda.synchronize()
                    err = float(((out - ref).abs() / scale).max())
                    same = torch.equal(ks, vs) and torch.equal(kscale, vscale)
                    ok = err <= 1e-15 * K and same
                    ms = graph_ms(call) if ok else float("nan")
                    mark = " <- plan" if (tile, split, groups) == (chosen.tile, chosen.split, chosen.groups) else ""
                    ctas = B * out_len // tile * split * groups
                    print(f"  {k} tile {tile:3d} split {split:2d} groups {groups} ({ctas:4d} CTAs): "
                          f"{ms:.4f} ms, {bound / ms:.1%} of bound, {ms / bmm_ms:.2f}x bmm; "
                          f"err {err:.2e}, slices equal {same}{mark}", flush=True)
                    rows.append(dict(entry=entry, shape=[B, m, n], slices=S, build=k, tile=tile, split=split,
                                     groups=groups, ms=ms, bound_ms=bound, bmm_ms=bmm_ms, err=err, slices_equal=same))
                    if not ok:
                        print("tune_ozaki: a configuration disagrees with the plain version", file=sys.stderr)
                        return 1
        del sm
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(device=torch.cuda.get_device_name(0), smi=smi, rows=rows)))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
