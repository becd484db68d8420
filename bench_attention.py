#!/usr/bin/env python3
"""Time the port's attention and norm kernels at ``chip_smoke.py`` phase
3's shapes, on one NVIDIA GPU.

    python3 bench_attention.py [--src DIR] [--label NAME] [--out FILE]
                               [--head-dim 64|128] [--encoders]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two trees can be compared on one card
in one call: unpack the other commit with ``git archive`` into a
directory that ``.gitignore`` lists and alternate the two, parent,
change, change, parent.  Only the public wrappers are called, so any
tree of the port since its paged verify window can be timed.

Rows (bf16, H=32, Hkv=4, G=8, D=128 or ``--head-dim``, page 16, inputs
from seed 0): the
fused decode (B=8 at positions up to 1000, and the serve's 4 slots at
positions 100-700) over fp and int8 pools, the verify window (B=4, S=5,
per-slot offsets 100-1000) over int8 and fp pools, the paged prefill at
S=256 (offset 256) and S=600 (offset 0) over fp and int8 pools, and
causal flash attention at Sq=Skv=512; then the unfused paged decode
(jamba's: Hkv=8, G=8, D=128, page 16, 64-entry tables) at phase 3's B=4
with lengths up to 1000 and at the serve-hybrid's 4 slots at lengths
100-700, bf16 and f32, fp and int8 pools; then the one-pass norm at the
front door's shapes (``chip_smoke.FRONT_DOOR_NORMS``, f32 scales, a bias
for layernorm).  Each row
gives the kernel's CUDA-event time (median of 20 launches, L2 flushed
before each: it includes the wrapper's host work whenever that outlasts
the kernel) and its device time (``torch.profiler``, the mean over 10
launches of the CUDA kernels each launch ran), and the same two for the
library yardstick: ``F.scaled_dot_product_attention`` on K/V gathered
beforehand, ``F.rms_norm`` or ``F.layer_norm`` (x-dtype parameters) for
the norms.  Then the flash kernel's numerics at the same
shape, D = 64 and 128: its largest distance from the plain version in
bf16 ulps, and its mean absolute error and the plain version's against
an f64 evaluation of the same function (``chip_smoke.flash_p_error``).
``--encoders`` times flash at the encoders' shapes instead
(``chip_smoke.ENCODER_FLASH``: the ViTs' Sq=Skv=197 at D=64, 40 and
60, whisper's encoder at Sq=Skv=1500, its cross decode and dense
self-decode), bf16 and f32, beside non-causal SDPA: the event and
device times above, and a third, ``burst``: one event pair around 50
launches back to back (warm, no flush), over 50, which the device sets
whenever a launch outlasts the host's dispatch of the next.
Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--head-dim", type=int, default=128, choices=(64, 128))
    ap.add_argument("--encoders", action="store_true",
                    help="time flash at the encoders' shapes instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import chip_smoke as C          # its timing helpers; it puts src first
    import torch
    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import paged_attention as TP
    from repro_torch.kernels import ref as TR
    F = torch.nn.functional
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    print(card)
    _build.load_library()
    dev, dt = "cuda", torch.bfloat16
    hk, g, d, page = 4, 8, args.head_dim, 16
    h = hk * g
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def gathered(kp, vp, ks, vs, bt):
        b, nb = bt.shape
        kg = TR.dequantize_int8(kp, ks) if ks is not None else kp.float()
        vg = TR.dequantize_int8(vp, vs) if vs is not None else vp.float()
        kg = kg[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
        vg = vg[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
        return (kg.repeat_interleave(g, 1).to(dt).contiguous(),
                vg.repeat_interleave(g, 1).to(dt).contiguous())

    def pools(n, quant):
        kq, ks = TR.quantize_int8_rows(rnd(n, page, hk, d))
        vq, vs = TR.quantize_int8_rows(rnd(n, page, hk, d))
        if quant:
            return (kq, vq), dict(k_scales=ks, v_scales=vs)
        return (TR.dequantize_int8(kq, ks).to(dt),
                TR.dequantize_int8(vq, vs).to(dt)), {}

    rows = []
    if args.encoders:
        rows = encoder_rows(args.label, C, TF, TR, flush)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"card": card, "label": args.label,
                           "src": args.src, "rows": rows}, f, indent=1)
        return 0 if all(r["ok"] for r in rows) else 1

    def row(name, kernel, plain, library, tol=C.TOL[dt]):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = C.max_err(out, ref)
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        r = dict(name=name, max_abs_err=err, ok=bool(ok),
                 ms=C.bench(kernel, flush), device_ms=C.device_ms(kernel,
                                                                   flush),
                 library_ms=C.bench(library, flush),
                 library_device_ms=C.device_ms(library, flush))
        print(f"[bench] {args.label} D={d} {name}: event {r['ms']:.4f} ms, "
              f"device {r['device_ms']:.4f} ms; library event "
              f"{r['library_ms']:.4f} ms, device "
              f"{r['library_device_ms']:.4f} ms; max_abs_err "
              f"{err:.3g} {'ok' if ok else 'MISMATCH'}")
        rows.append(r)

    # fused decode: B=8 at positions up to 1000, and 4 slots at 100-700
    nb = 64
    for b, pos in ((8, [999, 15, 16, 511, 256, 3, 640, 1000]),
                   (4, [100, 371, 640, 700])):
        bt = torch.randperm(b * nb, generator=gen, device=dev).reshape(
            b, nb).to(torch.int32)
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        q, kn, vn = (rnd(b, hk, g, d).to(dt), rnd(b, hk, d).to(dt),
                     rnd(b, hk, d).to(dt))
        mask = (torch.arange(nb * page, device=dev)[None, :]
                <= pos[:, None].long())[:, None, None, :]
        for quant in (False, True):
            pl, sc = pools(b * nb + 1, quant)
            kg, vg = gathered(*pl, sc.get("k_scales"), sc.get("v_scales"),
                              bt)
            mine = [t.clone() for t in pl]
            msc = {k: v.clone() for k, v in sc.items()}
            row(f"fused_paged_decode {'int8' if quant else 'fp'} B={b}",
                lambda: TP.fused_paged_decode_grouped(
                    q, kn, vn, *mine, bt, pos, theta=5e6, **msc)[0],
                lambda: TR.fused_paged_decode_ref(
                    q, kn, vn, *pl, bt, pos, theta=5e6, **sc)[0],
                lambda: F.scaled_dot_product_attention(
                    q.reshape(b, h, 1, d), kg, vg, attn_mask=mask))

    # verify window: B=4, S=5 at per-slot offsets 100-1000
    b, nb, s = 4, 64, 5
    bt = torch.randperm(b * nb, generator=gen, device=dev).reshape(
        b, nb).to(torch.int32)
    offs = torch.tensor([100, 371, 640, 1000], dtype=torch.int32,
                        device=dev)
    q = rnd(b, hk, g, s, d).to(dt)
    qpos = offs.long()[:, None] + torch.arange(s, device=dev)[None]
    mask = (torch.arange(nb * page, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]
    for quant in (True, False):
        pl, sc = pools(b * nb + 1, quant)
        kg, vg = gathered(*pl, sc.get("k_scales"), sc.get("v_scales"), bt)
        row(f"paged_verify {'int8' if quant else 'fp'}",
            lambda: TP.paged_verify_attention_grouped(q, *pl, bt, offs, **sc),
            lambda: TR.paged_verify_attention_ref(q, *pl, bt, offs, **sc),
            lambda: F.scaled_dot_product_attention(
                q.reshape(b, h, s, d), kg, vg, attn_mask=mask))

    # paged prefill: S=256 at offset 256, S=600 at offset 0
    nb = 64
    bt = torch.randperm(nb, generator=gen, device=dev)[None].to(torch.int32)
    for quant in (False, True):
        pl, sc = pools(nb + 1, quant)
        kg, vg = gathered(*pl, sc.get("k_scales"), sc.get("v_scales"), bt)
        for s, offset in ((256, 256), (600, 0)):
            q = rnd(1, hk, g, s, d).to(dt)
            mask = (torch.arange(nb * page, device=dev)[None, :]
                    <= offset + torch.arange(s, device=dev)[:, None])
            row(f"paged_prefill {'int8' if quant else 'fp'} S={s} "
                f"offset={offset}",
                lambda: TP.paged_prefill_attention_grouped(
                    q, *pl, bt, offset, **sc),
                lambda: TR.paged_prefill_attention_ref(q, *pl, bt, offset,
                                                       **sc),
                lambda: F.scaled_dot_product_attention(
                    q.reshape(1, h, s, d), kg, vg, attn_mask=mask))

    # flash: Sq=Skv=512, causal
    s = 512
    q = rnd(1, h, s, d).to(dt)
    k, v = rnd(1, hk, s, d).to(dt), rnd(1, hk, s, d).to(dt)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    ones = torch.ones((s,), dtype=torch.int32, device=dev)
    kr = k.repeat_interleave(g, 1).contiguous()
    vr = v.repeat_interleave(g, 1).contiguous()
    row("flash_attention causal 512",
        lambda: TF.flash_attention_bhsd(q, k, v, pos, pos, ones),
        lambda: TR.flash_attention_ref(q, k, v, pos, pos, ones),
        lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True))

    # the unfused paged decode (Hkv=8): phase 3's lengths and the
    # serve-hybrid's, each dtype and pool kind
    hk8, nb = 8, 64
    h8 = hk8 * g
    for lens in ([1000, 17, 512, 256], [100, 371, 640, 700]):
        b = len(lens)
        bt = torch.randperm(b * nb, generator=gen, device=dev).reshape(
            b, nb).to(torch.int32)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = (torch.arange(nb * page, device=dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        kq, ks = TR.quantize_int8_rows(rnd(b * nb + 1, page, hk8, d))
        vq, vs = TR.quantize_int8_rows(rnd(b * nb + 1, page, hk8, d))
        for adt in (torch.bfloat16, torch.float32):
            q = rnd(b, hk8, g, d).to(adt)
            kg = TR.dequantize_int8(kq, ks)[bt.long()].reshape(
                b, nb * page, hk8, d).transpose(1, 2)
            vg = TR.dequantize_int8(vq, vs)[bt.long()].reshape(
                b, nb * page, hk8, d).transpose(1, 2)
            kg = kg.repeat_interleave(g, 1).to(adt).contiguous()
            vg = vg.repeat_interleave(g, 1).to(adt).contiguous()
            for quant in (False, True):
                pl = (kq, vq) if quant else (
                    TR.dequantize_int8(kq, ks).to(adt),
                    TR.dequantize_int8(vq, vs).to(adt))
                sc = dict(k_scales=ks, v_scales=vs) if quant else {}
                row(f"paged_attention {'int8' if quant else 'fp'} "
                    f"{str(adt)[6:]} lengths {lens}",
                    lambda: TP.paged_attention_grouped(q, *pl, bt, lengths,
                                                       **sc),
                    lambda: TR.paged_attention_ref(q, *pl, bt, lengths,
                                                   **sc),
                    lambda: F.scaled_dot_product_attention(
                        q.reshape(b, h8, 1, d), kg, vg, attn_mask=mask),
                    tol=C.TOL[adt])

    # the one-pass norm at the front door's shapes
    from repro_torch.kernels.layernorm import norm_onepass
    for name, (r, dn, kind, ndt) in C.FRONT_DOOR_NORMS.items():
        x = (rnd(r, dn) * 3 + 1).to(ndt)
        scale = rnd(dn)
        bias = rnd(dn) if kind == "layernorm" else None
        ls = scale.to(ndt)
        if kind == "layernorm":
            lib = functools.partial(F.layer_norm, x, (dn,), ls, bias.to(ndt),
                                    1e-6)
        else:
            lib = functools.partial(F.rms_norm, x, (dn,), ls, 1e-6)
        row(f"{name} R={r} D={dn} {kind} {str(ndt)[6:]}",
            lambda: norm_onepass(x, scale, bias, kind=kind, eps=1e-6),
            lambda: TR.norm_onepass_ref(x, scale, bias, kind=kind, eps=1e-6),
            lib, tol=C.NORM_TOL[ndt])

    for d_ in (64, 128):
        e = C.flash_p_error(TF, TR, dev, d_)
        print(f"[bench] {args.label} flash numerics D={d_}: max "
              f"{e['max_ulps']:.3g} bf16 ulps from the plain version ("
              f"{e['raw_max_ulps']:.3g} with no floor, {e['raw_over_1ulp']} "
              f"elements beyond one; the plain version "
              f"{e['plain_f64_max_ulps']:.3g} from the rounded f64); mean "
              f"|err| vs f64 {e['mean_err']:.4g} (plain "
              f"{e['plain_mean_err']:.4g}, ratio {e['ratio']:.4f})")
        rows.append(dict(name=f"flash numerics D={d_}", ok=True, **e))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "label": args.label, "src": args.src,
                       "head_dim": d, "rows": rows}, f, indent=1)
    return 0 if all(r["ok"] for r in rows) else 1


def encoder_rows(label, C, TF, TR, flush):
    """Flash at ``chip_smoke.ENCODER_FLASH``'s shapes, bf16 and f32,
    queries at ``chip_smoke.QSTD``, beside non-causal SDPA (the
    self-decode's with its mask): event, device and burst times."""
    import torch
    F = torch.nn.functional
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(29)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for row in C.ENCODER_FLASH:
            name, causal = row[0], row[6]
            args, mask = C.encoder_flash_inputs(row, dtype, gen, dev)
            q, k, v = args[:3]
            kernel = functools.partial(TF.flash_attention_bhsd, *args,
                                       causal=causal)
            lib = functools.partial(F.scaled_dot_product_attention, q, k, v,
                                    attn_mask=mask)
            out = kernel()
            ref = TR.flash_attention_ref(*args, causal=causal)
            torch.cuda.synchronize()
            tol = C.TOL[dtype]
            ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
            r = dict(name=name, dtype=str(dtype)[6:], ok=bool(ok),
                     max_abs_err=C.max_err(out, ref),
                     ms=C.bench(kernel, flush),
                     device_ms=C.device_ms(kernel, flush),
                     burst_ms=C.burst_ms(kernel, n=50)[0],
                     library_ms=C.bench(lib, flush),
                     library_device_ms=C.device_ms(lib, flush),
                     library_burst_ms=C.burst_ms(lib, n=50)[0])
            print(f"[bench] {label} {name} {r['dtype']}: event "
                  f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, burst "
                  f"{r['burst_ms']:.4f} ms; sdpa event {r['library_ms']:.4f} "
                  f"ms, device {r['library_device_ms']:.4f} ms, burst "
                  f"{r['library_burst_ms']:.4f} ms; max_abs_err "
                  f"{r['max_abs_err']:.3g} {'ok' if ok else 'MISMATCH'}")
            rows.append(r)
    return rows


if __name__ == "__main__":
    sys.exit(main())
