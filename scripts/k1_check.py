#!/usr/bin/env python3
"""K1 (pytracking_tpu_torch/csrc/fused_mha.cu) on an NVIDIA H100: its pieces
on their own, and a sweep of its launch shape.

    python3 scripts/k1_check.py pieces   # QK^T and PV of single tiles vs torch
    python3 scripts/k1_check.py sweep    # kernel variants, timed in turns
    python3 scripts/k1_check.py sass     # the bf16 kernel's instruction mix

`pieces` builds scripts/k1_pieces.cu (the kernel's own TMA, descriptor and
wgmma helpers on one warpgroup) and checks QK^T of 64x64 tiles and P V for
P = identity, a one-hot P and a random P, against torch.

`sweep` builds copies of fused_mha.cu with other values of its launch-shape
constants (consumer warpgroups and CTAs per SM, CTAs per cluster) or with a
part of its work replaced, all nvcc runs at once, checks each against the
plain version at the TaMOs shape (the replaced ones are timed only) and
times each on the main path's mask and on a random mask, the variants in
turns (forward, then backward).

`sass` disassembles the built library (cuobjdump) and counts the bf16
kernel's instructions by opcode.

Run from the repository root; needs a card.
"""

import ctypes
import os
import re
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from pytracking_tpu_torch.ops import fused_mha  # noqa: E402

OUT_DIR = os.path.join(fused_mha.BUILD_DIR, "k1_check")
SHAPE = (2, 2592, 8, 32)
# pieces of fused_mha.cu that the variants replace
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
PV = "wgmma_m64n32k16_rs(o, a, dv + ((kk * 16 * 64) >> 4));"
QK = ("  wgmma_m64n64k16_ss(s, dq, dk, 0);\n"
      "  wgmma_m64n64k16_ss(s, dq + (32 >> 4), dk + (32 >> 4), 1);\n")
N_LIVE = "const int n_live = sm.n_live;"
ENTRY = "  extern __shared__ uint8_t smem_raw[];\n  SharedBf16& sm"
SOFTMAX = "softmax_tile(s, keep_bits[live[i + 1]], scale, quad, rows, p_next, alpha0, alpha1);"
NS = "for (int r = 0; r < 16; ++r) p_next[r] = pack_bf16(s[2 * r], s[2 * r + 1]);"
# name: (constants of fused_mha.cu replaced in the copy, text replaced, checked).
# Unchecked variants compute something else and are timed only, to show what
# a part of the kernel costs.
VARIANTS = {
    "source": ({}, {}, True),
    "cta4": ({"kBlocksPerSM": 4}, {}, True),
    "wg2_cta2": ({"kConsumerWGs": 2, "kBlocksPerSM": 2}, {}, True),
    "no_exp": ({}, {EX2: "y = x;"}, False),
    "no_softmax": ({}, {SOFTMAX: NS}, False),
    "no_softmax_no_pv": ({}, {SOFTMAX: NS, PV: "(void)a;"}, False),
    "no_softmax_no_qk": ({}, {SOFTMAX: NS, QK: ""}, False),
    "no_softmax_no_mma": ({}, {SOFTMAX: NS, PV: "(void)a;", QK: ""}, False),
    "pv_twice": ({}, {PV: PV + "\n    " + PV}, False),
    "one_tile": ({}, {N_LIVE: "const int n_live = 1;"}, False),
    "empty": ({}, {ENTRY: "return;\n" + ENTRY}, False),
}


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def time_ms(fn, iters=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)    # the host queues every launch before the card runs them
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pieces():
    os.makedirs(OUT_DIR, exist_ok=True)
    so = os.path.join(OUT_DIR, "libk1_pieces.so")
    res = subprocess.run(fused_mha.nvcc_command(os.path.join(REPO, "scripts", "k1_pieces.cu"),
                                                so), capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    lib.piece_qk_run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    lib.piece_pv_run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    g = torch.Generator().manual_seed(0)
    B, L, H, D = 2, 300, 3, 32
    q, k, v = (torch.randn(B, L, H, D, generator=g).to("cuda", torch.bfloat16)
               for _ in range(3))

    def tile(x, b, r0, h):      # rows r0..r0+63 of one head, zero past L
        t = torch.zeros(64, D, device="cuda")
        rows = x[b, r0:r0 + 64, h].float()
        t[:rows.shape[0]] = rows
        return t

    worst = 0.0
    for h, b, q0, k0 in [(0, 0, 0, 0), (2, 1, 64, 256), (1, 0, 256, 128)]:
        S = torch.zeros(64, 64, device="cuda")
        rc = lib.piece_qk_run(q.data_ptr(), k.data_ptr(), S.data_ptr(), B, L, H, h, b, q0, k0)
        err = (S - tile(q, b, q0, h) @ tile(k, b, k0, h).T).abs().max().item()
        print(f"QK^T head {h} entry {b} queries {q0} keys {k0}: rc {rc}, max err {err:.3e}")
        worst = max(worst, err if rc == 0 else float("inf"))
    onehot = torch.zeros(64, 64, device="cuda")
    onehot[torch.arange(64), (torch.arange(64) * 7 + 3) % 64] = 1
    for name, P in (("identity", torch.eye(64, device="cuda")), ("one-hot", onehot),
                    ("random", torch.rand(64, 64, generator=g).cuda())):
        O = torch.zeros(64, 32, device="cuda")
        rc = lib.piece_pv_run(v.data_ptr(), P.data_ptr(), O.data_ptr(), B, L, H, 1, 1, 128)
        err = (O - P.bfloat16().float() @ tile(v, 1, 128, 1)).abs().max().item()
        print(f"PV, P {name}: rc {rc}, max err {err:.3e}")
        worst = max(worst, err if rc == 0 else float("inf"))
    print(f"pieces: worst error {worst:.3e} (<= 1e-3)")
    return worst <= 1e-3


def build_variants():
    with open(fused_mha.SOURCE) as f:
        src = f.read()
    procs = {}
    for name, (consts, swaps, _) in VARIANTS.items():
        text = src
        for const, value in consts.items():
            text, n = re.subn(rf"(constexpr int {const} = )\d+;", rf"\g<1>{value};", text)
            assert n == 1, const
        for old, new in swaps.items():
            assert old in text, old
            text = text.replace(old, new)
        d = os.path.join(OUT_DIR, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "fused_mha.cu"), "w") as f:
            f.write(text)
        so = os.path.join(d, "libfused_mha.so")
        procs[name] = (so, subprocess.Popen(
            fused_mha.nvcc_command(os.path.join(d, "fused_mha.cu"), so, verbose=True),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0]
        regs = [ln.strip() for ln in out.splitlines() if "Used" in ln]
        notes = [ln.strip() for ln in out.splitlines() if "wgmma" in ln or "arning" in ln]
        print(f"{name}: nvcc rc {p.returncode}; bf16 kernel: {regs[-1] if regs else out[-2000:]}"
              + "".join(f"\n    {ln}" for ln in notes))
        if p.returncode == 0:
            lib = ctypes.CDLL(so)
            lib.fused_mha_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                          + [ctypes.c_float, ctypes.c_void_p])
            libs[name] = lib
    return libs


def sweep():
    libs = build_variants()
    B, L, H, D = SHAPE
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=g).to("cuda", torch.bfloat16) for _ in range(3))
    main = torch.ones(B, L, dtype=torch.bool)
    main[:, L // 3:2 * L // 3] = False
    masks = {"main": main.cuda(), "random": (torch.rand(B, L, generator=g) > 0.3).cuda()}
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, keep):
        return lambda: lib.fused_mha_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         keep.data_ptr(), out.data_ptr(), B, L, H, D, 1,
                                         D ** -0.5, stream)

    ok = len(libs) == len(VARIANTS)      # every variant built
    for name, lib in libs.items():
        for what, keep in masks.items():
            rc = call(lib, keep)()
            torch.cuda.synchronize()
            ref = fused_mha.fused_self_attention_reference(q, k, v, keep)
            err = (out.float() - ref.float()).abs().max().item()
            checked = VARIANTS[name][2]
            print(f"{name} {what}: rc {rc}, max|kernel-plain| {err:.3e} "
                  f"{'(<= 2e-2)' if checked else '(timed only)'}")
            ok &= rc == 0 and (err <= 2e-2 or not checked)
    times = {(n, w): [] for n in libs for w in masks}
    order = list(libs) + list(libs)[::-1]
    for name in order:
        for what, keep in masks.items():
            times[(name, what)].append(time_ms(call(libs[name], keep)))
    sdpa = {w: time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (q, k, v)), attn_mask=m[:, None, None, :]))
        for w, m in masks.items()}
    print(f"sweep on {card()}, (B, L, H, D) = {SHAPE}, ms per launch (two turns):")
    for name in libs:
        row = "  ".join(f"{w} {' / '.join(f'{t:.4f}' for t in times[(name, w)])}"
                        for w in masks)
        print(f"  {name:14s} {row}")
    print(f"  {'SDPA':14s} " + "  ".join(f"{w} {t:.4f}" for w, t in sdpa.items()))
    return ok


def sass():
    lib = fused_mha.build()
    cuobjdump = os.path.join(os.path.dirname(fused_mha.nvcc_command("x", "y")[0]), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"cuobjdump failed: {res.stderr}")
    kernels = re.split(r"\n\s*Function : ", res.stdout)
    body = next(k for k in kernels if "mha_fwd_bf16_sm90" in k.split("\n", 1)[0])
    ops = re.findall(r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
    counts = {}
    for _, op in ops:
        base = op.split(".")[0]
        counts[base] = counts.get(base, 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])
    print(f"bf16 kernel: {len(ops)} SASS instructions; by opcode: "
          + ", ".join(f"{k} {v}" for k, v in top[:40]))
    return len(ops) > 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("k1_check: needs an NVIDIA card")
    t0 = time.perf_counter()
    ok = {"pieces": pieces, "sweep": sweep, "sass": sass}[sys.argv[1]]()
    print(f"k1_check {sys.argv[1]}: {'ok' if ok else 'FAILED'} in "
          f"{time.perf_counter() - t0:.1f} s")
    sys.exit(0 if ok else 1)
