#!/usr/bin/env python3
"""Time variants of the port's f32 kernel routes on one CUDA card.

    python3 tools/kernel_variants.py [PRESET | tree=DIR] ...

Builds the fused conv3x3+BN+GELU kernels (``csrc/cbg.cu``) and the fused GRU
forward and backward (``csrc/fused_gru.cu``, ``csrc/fused_gru_bwd.cu``) of
``deflow_tpu_torch`` once as they are ("base") and once for each argument,
each from a copy of the sources: a PRESET applies the text edits of
``PRESETS`` below (probes skip work and give wrong results on purpose: they
show what a part of a kernel costs); ``tree=DIR`` builds the sources of
another checkout unpacked in DIR (say, a parent commit).  Every build is
compiled with the port's nvcc flags, loaded with ctypes and swapped into
the wrappers in turns (a, b, ..., b, a), timed with CUDA events at the
main path's shapes (chip_smoke.py's phase 3: the f32 routes, TF32 off) and
held against the plain versions (error relative to the largest reference
element; whether two launches agree bit for bit).  Then each build's
block backward is split by kernel under torch.profiler.  Prints the
card's name and power limit first and last.

Imports nothing of JAX or of the JAX package.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCES = ("cbg", "fused_gru", "fused_gru_bwd")

_DG_STEP = """      if (busy)
        dg32_step(acc, win + ((f_row + 2 - ky) * WIN + lp + 2 - kx) * ld, ld,
                  s_w + (tap & 1) * tap_elems + (tc * 32 + lc) * ld, ld, ok);"""
_DG_LOOP = """    for (int tap = 0; tap < 9; ++tap) {
      if (tap + 1 < 9) {
        load_tap(tap + 1, o0, s_w + ((tap + 1) & 1) * tap_elems);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int ky = tap / 3, kx = tap % 3;
""" + _DG_STEP + """
      __syncthreads();
    }"""
_DG_ONE_BARRIER = """    for (int tap = 0; tap < 9; ++tap) {
      cp_async_wait<0>();
      __syncthreads();
      if (tap + 1 < 9) {
        load_tap(tap + 1, o0, s_w + ((tap + 1) & 1) * tap_elems);
        cp_async_commit();
      }
      const int ky = tap / 3, kx = tap % 3;
""" + _DG_STEP + """
    }
    __syncthreads();"""
_DG_WINDOW = "    for (int i = tid; i < (R + 2) * WIN * och; i += THREADS) {"
_DG_LOADS = """        ld_vec(dv, dz + e, o - oi, vec);
        ld_vec(sv, si + e, o - oi, vec);"""
_WG_ROWS = """      for (int r = 0; r < R; ++r)
        wg32_row(acc, sx + (r + ky) * WIN * 64 + cl, sd + r * TP * 64 + ol);"""
_FETCH = """    cp_async16(dst + r * b.cols + c, ok ? b.p + (size_t)(k0 + r) * b.ld + c : b.p, ok);
  }
  cp_async_commit();"""

# name: [(file in csrc, old text, new text), ...]
PRESETS = {
    # the GRU forward's f32 kernel
    "gru_rows4": [("fused_gru.cu", "constexpr int F32_RI = 8;", "constexpr int F32_RI = 4;")],
    "gru_unroll2": [("fused_gru.cu", "constexpr int F32_UNROLL = 4;",
                     "constexpr int F32_UNROLL = 2;")],
    "gru_ieee_gates": [
        ("fused_gru.cu", "float sigmoid_rcp(float v) { return __fdividef(1.f, 1.f + expf(-v)); }",
         "float sigmoid_rcp(float v) { return 1.f / (1.f + expf(-v)); }"),
        ("fused_gru.cu", "float tanh_rcp(float v) { return 2.f * sigmoid_rcp(2.f * v) - 1.f; }",
         "float tanh_rcp(float v) { return tanhf(v); }")],
    "gru_stage16": [("gru_tile.cuh", "constexpr int F_WST = 32 * 2 * F_H;",
                     "constexpr int F_WST = 16 * 2 * F_H;")],
    "gru_probe_no_weight_copies": [("gru_tile.cuh", _FETCH,
                                    "    (void)ok;\n    (void)c;\n  }\n  cp_async_commit();")],
    # the GRU backward's f32 main kernel (f32_mm's default unroll)
    "gru_bwd_unroll4": [("gru_tile.cuh", "template <int NG, int RI, int UNROLL = 2>",
                         "template <int NG, int RI, int UNROLL = 4>")],
    # the block backward's f32 dgrad and wgrad
    "dg_one_barrier": [("cbg.cu", _DG_LOOP, _DG_ONE_BARRIER)],
    "dg_window_unroll4": [("cbg.cu", _DG_WINDOW, "#pragma unroll 4\n" + _DG_WINDOW)],
    "dg_probe_no_products": [("cbg.cu", _DG_STEP, "      (void)busy;")],
    "dg_probe_no_loads": [("cbg.cu", _DG_LOADS,
                           "        for (int q = 0; q < 4; ++q) dv[q] = sv[q] = 0.5f;")],
    "wg_probe_no_products": [("cbg.cu", _WG_ROWS, "      for (int r = 0; r < 0; ++r) {}")],
}


def builds(args):
    """[(name, tree, edits)] for the base and each argument."""
    out = [("base", ROOT, [])]
    for a in args:
        if a.startswith("tree="):
            tree = os.path.abspath(a[5:])
            out.append((os.path.basename(tree.rstrip("/")), tree, []))
        elif a in PRESETS:
            out.append((a, ROOT, PRESETS[a]))
        else:
            raise SystemExit(f"unknown preset {a!r}; presets: {', '.join(PRESETS)}")
    return out


def compile_all(todo, tmp):
    """Compile every build's sources in parallel; {(name, source): .so path}
    and each build's ptxas lines."""
    from deflow_tpu_torch.ops import _build

    procs = {}
    for name, tree, edits in todo:
        csrc = os.path.join(tmp, name)
        shutil.copytree(os.path.join(tree, "deflow_tpu_torch", "csrc"), csrc)
        for fname, old, new in edits:
            path = os.path.join(csrc, fname)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f"{name}: edit not found in {fname}: {old[:80]!r}")
            open(path, "w").write(text.replace(old, new))
        for src in SOURCES:
            so = os.path.join(tmp, f"lib{src}_{name}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so,
                   os.path.join(csrc, f"{src}.cu")]
            procs[(name, src)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), so)
    out, logs = {}, {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key[0]} {key[1]}: build failed\n{log[-6000:]}")
        out[key] = so
        logs.setdefault(key[0], []).append(log)
    return out, logs


def calls(torch, cs, cbg, gru):
    """(label, source, kernel call, plain outputs) at the path's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s, k=1.0: torch.randn(*s, generator=g, device=dev) * k  # noqa: E731
    out = []
    for m in (4 * 98304, 2 * 98304):
        a = [rnd(m, 128, k=0.5), rnd(m, 64, k=0.5), rnd(192, 256, k=0.1), rnd(256, k=0.1),
             rnd(192, 128, k=0.1), rnd(128, k=0.1)]
        out.append((f"fused_gru f32 {m}", "fused_gru", lambda a=a: gru.fused_gru(*a, 4),
                    gru.fused_gru_plain(*a, 4)))
    m = 2 * 98304
    a = [rnd(m, 128, k=0.5), rnd(m, 64, k=0.5), rnd(192, 256, k=0.1), rnd(256, k=0.1),
         rnd(192, 128, k=0.1), rnd(128, k=0.1), rnd(m, 128)]
    out.append((f"fused_gru_bwd f32 {m}", "fused_gru_bwd",
                lambda a=a: gru.fused_gru_bwd(*a, 4), gru.fused_gru_bwd_plain(*a, 4)))
    for res, c in ((256, 64), (128, 128), (64, 256)):
        shape = (4, res, res, c)
        ones = torch.ones(c, device=dev)
        scal = cbg.scal_slab(rnd(c, k=0.1), torch.rand(c, generator=g, device=dev) + 0.5,
                             1.05 * ones, 0.02 * ones)
        scal_in = cbg.scal_slab(rnd(c, k=0.1), torch.rand(c, generator=g, device=dev) + 0.5,
                                1.1 * ones, 0.01 * ones, rnd(c, k=0.01), rnd(c, k=0.01))
        a = (rnd(*shape), rnd(*shape), rnd(*shape), rnd(3, 3, c, c, k=(9 * c) ** -0.5),
             scal_in, scal)

        def run(a=a):
            r = cbg.cbg_block_bwd(*a)
            return r[0], r[1], r[2].sum(0), r[3].sum(0)

        ref = cbg.cbg_block_bwd_plain(*a)
        out.append((f"cbg_bwd f32 {res}^2x{c}", "cbg", run,
                    (ref[0], ref[1], ref[2].sum(0), ref[3].sum(0))))
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deflow_tpu_torch.ops import _build, cbg, gru

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    todo = builds(argv)
    setup = {"cbg": cbg._setup, "fused_gru": gru._setup, "fused_gru_bwd": gru._setup_bwd}
    tmp = tempfile.mkdtemp(prefix="kernel_variants_")
    try:
        sos, logs = compile_all(todo, tmp)
        libs = {}
        for (name, src), so in sos.items():
            lib = ctypes.CDLL(so)
            lib.error_string.restype = ctypes.c_char_p
            lib.error_string.argtypes = [ctypes.c_int]
            setup[src](lib)
            libs[(name, src)] = lib
        for name, _, _ in todo:
            for line in cs.ptxas_lines("\n".join(logs[name])):
                if "f32" in line and "registers" in line:
                    print(f"  {name}: {line}")
        work = calls(torch, cs, cbg, gru)
        names = [name for name, _, _ in todo]
        res = {}
        for name in names + names[::-1]:
            for label, src, fn, ref in work:
                _build._LIBS[src] = libs[(name, src)]
                first, second = fn(), fn()
                torch.cuda.synchronize()
                outs = first if isinstance(first, tuple) else (first,)
                again = second if isinstance(second, tuple) else (second,)
                refs = ref if isinstance(ref, tuple) else (ref,)
                err = max(cs._rel_err(o, r) for o, r in zip(outs, refs))
                same = all(torch.equal(o, p) for o, p in zip(outs, again))
                res.setdefault((name, label), []).append((cs.cuda_ms(fn, 10), err, same))
        for (name, label), runs in res.items():
            print(f"{name:>28} {label:>26}: " + ", ".join(
                f"{ms:.4f} ms (rel err {e:.1e}{'' if s else ', not repeated'})"
                for ms, e, s in runs))
        for name in names:
            for label, src, fn, _ in work:
                if src == "cbg":
                    _build._LIBS[src] = libs[(name, src)]
                    split = cs.kernel_split(fn, 5)
                    print(f"{name:>28} {label:>26} split: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in sorted(split.items()) if "cbg" in k
                        or "wgrad" in k))
    finally:
        _build._LIBS.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
