#!/usr/bin/env python3
"""What bounds the ``flash_decode`` CUDA kernel: time it beside a copy-only
and a compute-only variant of its own source on one CUDA card.

    python3 tools/flash_decode_probe.py [--dtype bfloat16|float32]
        [--shapes fd|d256] [--keys-per-split N ...]

Each variant is ``src/repro_torch/kernels/csrc/flash_decode.cu`` with
text edits, built with the port's flags (``-Xptxas -v`` among them) into
``build/probe/`` (one ``nvcc`` per variant, all started together):

- ``base``: the source as it is;
- ``copy_only``: each warp waits for every tile of its ring and drops it
  (the wide kernel's consumer warps hand each stage straight back to the
  copy warps): the copy pipeline alone (the output is wrong);
- ``compute_only``: no copy is issued (the wide kernel's copy warps still
  arrive on each stage): the arithmetic on whatever the rings hold (the
  output is wrong).

It prints each kernel's registers and spills from ``ptxas``, then each
variant's device time at ``chip_smoke.py``'s FD_SHAPES (``--shapes
d256``: its PALI_FD, paligemma's MQA at head dim 256) with the same
input maker and the same CUDA-graph timing, beside the HBM bound: at the
split plan's keys per split and at each ``--keys-per-split`` given. It
raises if an edit no longer matches the source. It imports no JAX.
Without a card it exits with 1.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                   "flash_decode.cu")
OUT = os.path.join(ROOT, "build", "probe")
VARIANTS = ("base", "copy_only", "compute_only")
# the first statement after a tile has landed, in each kernel's loop
TILE_READY = "\n    const int t0 = sp.k0 + (warp + i * kWarps) * C::kKeys;\n"
# ... and in the wide kernel's (bf16 past D 128), whose consumer warps
# hand each stage back to the copy warps on its empty barrier
WIDE_TILE_READY = "\n      const uint32_t base = ring + st * C::kStage;\n"
WIDE_RELEASE = ("\n      if (t >= 0) {\n        __syncwarp();\n"
                "        if (lane == 0) mbar_arrive(empty + 8 * st);\n"
                "        continue;\n      }")
EDITS = {
    "copy_only": [
        lambda s: s.replace(TILE_READY, TILE_READY + "    if (i >= 0) {\n"
                            "      __syncwarp();\n      continue;\n    }\n"),
        lambda s: s.replace(WIDE_TILE_READY, WIDE_RELEASE + WIDE_TILE_READY)],
    "compute_only": [
        lambda s: re.sub(r"cp_async16\(st \+[^;]*;", "", s),
        # the wide kernel's copy warps still arrive on each stage
        lambda s: re.sub(r"cp_async16\(sdst \+[^;]*;", "", s)],
}


def variant(name: str, src: str) -> str:
    out = src
    for edit in EDITS.get(name, []):
        edited = edit(out)
        if edited == out:
            raise RuntimeError(f"variant {name!r}: an edit matches nothing: "
                               "the source changed under it")
        out = edited
    return out


def build() -> dict[str, tuple[str, str]]:
    """{variant: (library path, ptxas report)}, built in parallel."""
    from repro_torch.kernels import build as kbuild
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC).read()
    jobs = {}
    for name in VARIANTS:
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant(name, src))
        so = os.path.join(OUT, f"{name}.so")
        # NVCC_FLAGS carry -Xptxas -v: the log holds ptxas's report
        cmd = [kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", so, cu]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    built = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        built[name] = (so, log)
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--shapes", default="fd", choices=["fd", "d256"],
                    help="chip_smoke.FD_SHAPES or chip_smoke.PALI_FD")
    ap.add_argument("--keys-per-split", type=int, nargs="*", default=[],
                    help="also time each variant at these splits")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_decode_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_decode as fdk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    bw, _ = cs.card_rates(smi)
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    dtype = getattr(torch, args.dtype)
    symbol = "flash_decode_bf16" if dtype == torch.bfloat16 else \
        "flash_decode_f32"
    fns = {}
    for name, (so, log) in build().items():
        fn = getattr(ctypes.CDLL(so), symbol)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fns[name] = fn
        print(f"{name}: {kbuild.parse_ptxas(log)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    tickets = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    shapes = cs.FD_SHAPES if args.shapes == "fd" else cs.PALI_FD
    for B, S, Hkv, G, D, lengths in shapes:
        q, k, v, lens = cs.fd_inputs(B, S, Hkv, G, D, lengths, dtype, gen)
        scale = D ** -0.5
        want = fdk.flash_decode_plain(q, k, v, lens, scale=scale).float()
        valid = int(lens.clamp(max=S).sum())
        size = q.element_size()
        nbytes = valid * Hkv * D * 2 * size + 2 * q.numel() * size + B * 4
        print(f"B={B} S={S} Hkv={Hkv} G={G} D={D} {args.dtype} ({lengths} "
              f"lengths, {valid} valid rows); HBM bound "
              f"{nbytes / bw * 1e3:.5f} ms", flush=True)
        plan = fdk.plan(q, k)
        for keys in [plan.keys_per_split] + args.keys_per_split:
            splits = -(-S // keys)
            ws = torch.empty((B * Hkv, splits, G, D + 2),
                             dtype=torch.float32, device="cuda")
            print(f" {splits} splits of {keys} keys, {B * Hkv * splits} "
                  f"CTAs{' (the plan)' if keys == plan.keys_per_split else ''}",
                  flush=True)
            for name, fn in fns.items():
                out = torch.empty_like(q)

                def call(fn=fn, out=out, ws=ws, splits=splits, keys=keys):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
                             tickets.data_ptr(), B, S, Hkv, G, D, scale,
                             0.0, splits, keys,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                call()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                ms = cs.device_ms(call, calls=cs.FD_CALLS[S])
                print(f"  {name:14s} {ms:.5f} ms  max abs err {err:.3g}",
                      flush=True)
        del q, k, v, lens, ws
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
