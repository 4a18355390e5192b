#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run with a nonzero exit:
  1. environment: torch, CUDA, nvcc, and the card's name and power limit;
  2. build: nvcc compiles every kernel source of the port (csrc/*.cu) for
     sm_90a, one process per source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes, with its time, its plain version's, the bound
     and a library yardstick;
  4. slice: the flagship VQDIF-16 + CondTupleGPT (20+4 layers, d=1024) with
     seeded random weights answers 3 completion requests through
     serve.complete (16384-point partial clouds, 4 candidates, top_k 100,
     top_p 0.4, up to 512 steps, 128^3 decode); outputs are checked, every
     kernel must have run on that path, and request 1's condition tokens
     must match the port's CPU run; one more request then runs under
     torch.profiler for the device's busy share and its top kernels;
  5. summary: a `kernels` JSON line, the nvidia-smi line, and as the last
     line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 rate outside the tensor cores
N_REQUESTS = 3


def _cmd_line(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def phase_environment(torch, kernels):
    nvcc = _cmd_line([kernels.nvcc_path(), "--version"]).splitlines()[-1]
    smi = _cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0]
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"[env] nvcc: {nvcc}")
    print(f"[env] nvidia-smi: {smi}")
    return smi


def phase_build(kernels):
    t0 = time.perf_counter()
    logs = kernels.build()
    dt = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(logs)} kernel libraries in {dt:.2f} s")


def time_ms(torch, fn, iters):
    """Mean device time of fn over iters launches (CUDA events), after a
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Summed device time of the kernels fn launches, per call
    (torch.profiler): unlike time_ms it leaves out the device's idle gaps
    between launches that the host issues more slowly than the card runs
    them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / iters / 1e3


def _sorted_features(torch, scatter, gridcoords, clouds, C, gen):
    """Cell-sorted (B, N, C) features and plan for clouds binned on the
    encoder's 64^3 grid, as LocalPoolPointnet bins them."""
    p = torch.as_tensor(clouds, device="cuda") / 2.0
    ids = gridcoords.coordinate2index(
        gridcoords.normalize_3d_coordinate(p, 0.1), 64)
    plan = scatter.pool_plan(ids)
    cs = torch.randn(p.shape[0], p.shape[1], C, device="cuda", generator=gen)
    return cs, plan


def phase_kernels(torch, clouds, seed):
    from shapeformer_tpu_torch.ops import gridcoords, scatter
    from shapeformer_tpu_torch.ops.segment_pool import (
        SegmentPool, segment_pool_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pool = SegmentPool()
    C = 32
    cases = {
        "B1_N16384": clouds[:1],
        "B4_N16384": clouds[:4],
        "B1_N16383": clouds[:1, :16383],
        "one_cell_N4097": clouds[:1, :4097] * 0.0,
    }
    max_err = 0.0
    for label, cl in cases.items():
        cs, plan = _sorted_features(torch, scatter, gridcoords, cl, C, gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = cs.to(dtype).contiguous()
            for mode in ("max", "mean"):
                got = pool(x, plan["offsets"], mode)
                want = segment_pool_plain(x, plan["offsets"], mode)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                if mode == "max" and not torch.equal(got, want):
                    raise AssertionError(f"segment_pool max {label} {dtype}: "
                                         f"kernel != plain (err {err})")
                if mode == "mean":
                    tol = (dict(rtol=1e-5, atol=1e-6)
                           if dtype == torch.float32
                           else dict(rtol=2 ** -7, atol=1e-6))
                    torch.testing.assert_close(got, want, **tol)
                if dtype == torch.float32:
                    max_err = max(max_err, err)
                print(f"[kernel] segment_pool {label} {str(dtype)[6:]} "
                      f"{mode}: S={plan['offsets'].numel() - 1} "
                      f"max_abs_err={err:.3e}")

    # timing at the main path's shape: B=1, N=16384, C=32, f32, mode max
    cs, plan = _sorted_features(torch, scatter, gridcoords, clouds[:1], C, gen)
    offsets = plan["offsets"]
    rows = cs.shape[0] * cs.shape[1]
    S = offsets.numel() - 1
    lengths = (offsets[1:] - offsets[:-1]).long()
    seg_id = torch.repeat_interleave(torch.arange(S, device="cuda"), lengths,
                                     output_size=rows)
    flat = cs.reshape(rows, C)
    res = {}
    for mode in ("max", "mean"):
        kernel_ms = time_ms(torch, lambda: pool(cs, offsets, mode), 200)
        plain_ms = time_ms(torch, lambda: segment_pool_plain(cs, offsets,
                                                             mode), 50)
        library_ms = time_ms(torch, lambda: torch.segment_reduce(
            flat, mode, lengths=lengths, axis=0)[seg_id], 200)
        lib = torch.segment_reduce(flat, mode, lengths=lengths, axis=0)[seg_id]
        torch.testing.assert_close(lib.reshape(cs.shape),
                                   segment_pool_plain(cs, offsets, mode),
                                   rtol=1e-5, atol=1e-6)
        n_bytes = 2 * rows * C * 4 + (S + 1) * 4
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = rows * C / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        res[mode] = dict(ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations")
        print(f"[kernel] segment_pool B1 N16384 C32 f32 {mode}: "
              f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={library_ms:.5f} bound_us={bound_ms * 1e3:.3f} "
              f"({n_bytes} bytes, S={S}, "
              f"{bound_ms / kernel_ms * 100:.2f}% of bound)")
        dev = [device_ms(torch, f, 50) for f in (
            lambda: pool(cs, offsets, mode),
            lambda: segment_pool_plain(cs, offsets, mode),
            lambda: torch.segment_reduce(flat, mode, lengths=lengths,
                                         axis=0)[seg_id])]
        print(f"[kernel] segment_pool B1 N16384 C32 f32 {mode} device time "
              f"per call (profiler, launch gaps excluded): "
              f"kernel_ms={dev[0]:.5f} plain_ms={dev[1]:.5f} "
              f"library_ms={dev[2]:.5f} "
              f"({bound_ms / dev[0] * 100:.2f}% of bound)")
    print(f"[kernel] comparison launches (not counted on the main path): "
          f"{pool.launches}")
    return res["max"], max_err


def _complete_kwargs(demo):
    """serve.complete's settings from the demo configuration."""
    return {k: demo[k] for k in ("sample_n", "top_k", "top_p", "temperature",
                                 "sample_max_step", "depth", "decode_res")}


class PhaseClock:
    """on_phase hook for serve.complete: device-synchronised phase times."""

    def __init__(self, torch):
        self.torch = torch
        self.times = {}
        self.info = {}
        torch.cuda.synchronize()
        self.last = time.perf_counter()

    def __call__(self, name, **info):
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        self.times[name] = (now - self.last) * 1e3
        self.info.update(info)
        self.last = now


def _check_request(torch, out, sf, demo):
    end = sf.end_tokens
    toks = out["samples"]
    n = demo["sample_n"]
    if toks.shape[0] != n or toks.shape[-1] != 2:
        raise AssertionError(f"samples shape {tuple(toks.shape)}")
    if not ((toks >= 0).all() and (toks[..., 0] <= end[0]).all()
            and (toks[..., 1] <= end[1]).all()):
        raise AssertionError("a token lies outside its vocabulary")
    if not torch.isfinite(out["log_prob"]).all():
        raise AssertionError("non-finite log-prob")
    logits = out["decoded_logits"]
    if tuple(logits.shape) != (n, demo["decode_res"] ** 3, 1):
        raise AssertionError(f"decoded logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite decoded logits")


def _compare_with_cpu(torch, sf, xct, card_out, sparse):
    """Request 1's condition tokens on the card == the port's CPU run,
    except cells whose top-2 code distances differ by less than 1e-4."""
    cpu_vq = copy.deepcopy(sf.representer.vqdif).to("cpu")
    rep = copy.copy(sf.representer)
    rep.set_vqdif(cpu_vq)
    x = torch.as_tensor(xct)
    with torch.no_grad():
        c_cpu, _, _, others = rep.get_indices(x)
        feat, _ = cpu_vq.encode(x)
        dist = cpu_vq.quantizer.distances(feat.reshape(-1, feat.shape[-1]))
    top2 = torch.topk(dist, 2, largest=False).values
    clear = ((top2[:, 1] - top2[:, 0]) >= 1e-4).reshape(feat.shape[:-1])
    empty = int(others["empty_index"])
    if empty != card_out["empty_index"]:
        raise AssertionError(f"empty code: card {card_out['empty_index']} "
                             f"cpu {empty}")
    reso = sf.voxel_res
    d_card = sparse.sparse2dense(card_out["c_ind"].cpu(), empty, reso)
    d_cpu = sparse.sparse2dense(c_cpu, empty, reso)
    differ = (d_card != d_cpu) & clear
    same_seq = bool(torch.equal(card_out["c_ind"].cpu(), c_cpu))
    n_tok = int((c_cpu[0, :, 0] != sf.end_tokens[0]).sum())
    print(f"[slice] request 1 condition tokens: {n_tok} tokens, sequences "
          f"equal={same_seq}, low-margin cells={int((~clear).sum())}, "
          f"differing clear cells={int(differ.sum())}")
    if differ.any() or (bool(clear.all()) and not same_seq):
        raise AssertionError("condition tokens on the card differ from the "
                             "CPU run")


def phase_slice(torch, clouds, seed):
    from shapeformer_tpu_torch import configs, serve
    from shapeformer_tpu_torch.ops import sparse
    demo = configs.DEMO
    t0 = time.perf_counter()
    sf = serve.build_completer("cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sf.transformer.parameters())
    print(f"[slice] flagship built in {time.perf_counter() - t0:.2f} s: "
          f"CondTupleGPT {n_params} parameters, layers "
          f"{sf.transformer.n_layers}, d={sf.transformer.n_embd}")
    pool = sf.representer.vqdif.encoder.segment_pool
    kw = _complete_kwargs(demo)
    torch.cuda.reset_peak_memory_stats()
    pool.launches = 0                       # counts of the main path only
    outs = []
    for r in range(N_REQUESTS):
        clock = PhaseClock(torch)
        before = pool.launches
        t_req = time.perf_counter()
        out = serve.complete(sf, clouds[r:r + 1], f"request{r}",
                             on_phase=clock, **kw)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t_req) * 1e3
        grew = pool.launches - before
        steps = clock.info["steps"]
        tm = clock.times
        print(f"[slice] request {r + 1}: tokenize_ms={tm['tokenize']:.2f} "
              f"prefill_ms={tm['prefill']:.2f} ar_steps={steps} "
              f"ar_ms={tm['ar_loop']:.2f} "
              f"ms_per_step={tm['ar_loop'] / max(steps, 1):.3f} "
              f"decode_ms={tm['decode']:.2f} total_ms={total_ms:.2f} "
              f"segment_pool_launches=+{grew}")
        _check_request(torch, out, sf, demo)
        if grew != 4:
            raise AssertionError(f"segment_pool ran {grew} times in request "
                                 f"{r + 1}, expected 4 (one per pooling)")
        outs.append(out)
    launches = pool.launches                # read right after the main path
    print(f"[slice] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"log_prob request 1 {outs[0]['log_prob'].tolist()}")
    _compare_with_cpu(torch, sf, clouds[:1], outs[0], sparse)
    phase_profile(torch, sf, clouds[:1])
    return launches


def phase_profile(torch, sf, cloud):
    """One more request under torch.profiler (after the main path's counts
    were read): the device's busy share of the wall time and the kernels
    that take it, by summed device time."""
    from torch.profiler import ProfilerActivity, profile

    from shapeformer_tpu_torch import configs, serve
    kw = _complete_kwargs(configs.DEMO)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.complete(sf, cloud, "request0", **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    if not spans:
        print("[profile] the profiler recorded no device time: "
              "device busy share not measured")
        return
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    print(f"[profile] request 1 again under the profiler: wall_ms="
          f"{wall_us / 1e3:.2f} device_busy_ms={busy / 1e3:.2f} "
          f"idle_share={1 - busy / wall_us:.4f} kernels={len(spans)}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {us / 1e3:9.2f} ms  {name[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the clouds, the features and the weights")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from shapeformer_tpu_torch import kernels
        from shapeformer_tpu_torch.data.synthetic import partial_cloud
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              f"the root of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_environment(torch, kernels)
    phase_build(kernels)
    rng = np.random.default_rng(args.seed)
    clouds = np.stack([partial_cloud(rng, 16384) for _ in range(4)])
    kstats, max_err = phase_kernels(torch, clouds, args.seed)
    launches = phase_slice(torch, clouds, args.seed)
    if launches == 0:
        raise AssertionError("segment_pool never ran on the main path")

    row = dict(name="segment_pool", route="cuda",
               source="shapeformer_tpu_torch/csrc/segment_pool.cu",
               replaces="shapeformer_tpu/ops/pallas_scatter.py:69",
               launches=launches, max_abs_err=max_err, ms=kstats["ms"],
               plain_ms=kstats["plain_ms"], bound_ms=kstats["bound_ms"],
               bound_by=kstats["bound_by"], library_ms=kstats["library_ms"])
    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
