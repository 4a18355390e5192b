#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run with a nonzero exit:
  1. environment: torch, CUDA, nvcc, and the card's name and power limit;
  2. build: nvcc compiles every kernel source of the port (csrc/*.cu) for
     sm_90a, one process per source, all started together;
  3. segment_pool: the kernel against its plain PyTorch version on the card
     at the serving path's shapes, with its time, its plain version's, the
     bound and a library yardstick;
  4. slice: the flagship VQDIF-16 + CondTupleGPT (20+4 layers, d=1024) with
     seeded random weights answers 3 completion requests through
     serve.complete (16384-point partial clouds, 4 candidates, top_k 100,
     top_p 0.4, up to 512 steps, 128^3 decode); outputs are checked, the
     pooling kernel must have run on that path, and request 1's condition
     tokens must match the port's CPU run; one more request then runs under
     torch.profiler for the device's busy share and its top kernels;
  5. attention: the forward, dQ and dK/dV kernels against their plain
     versions at the training shape (B=8, H=16, T=811, D=64, packed
     projection views, key validity of the training batch's real token
     sequences), f32 and bf16, with times, bounds and
     F.scaled_dot_product_attention as the library yardstick;
  6. train: systems.ShapeFormerSystem at flagship width with flash_attn on
     and the dropouts at 0 takes 3 train steps and 1 eval step on 8
     synthetic examples (16384-point partial scan, 32768-point whole
     surface); loss, gradients, parameter movement and the launch counts of
     all four kernels are checked; one more step runs under torch.profiler;
  7. whole path: loss and every gradient leaf of one batch of 2 with the
     attention kernels against the same pass with torch-op attention;
  8. summary: a `kernels` JSON line, the nvidia-smi line, and as the last
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
TRAIN_STEPS = 3


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


def device_ms(torch, fn, iters, event_ms=None):
    """Summed device time of the kernels fn launches, per call
    (torch.profiler): unlike time_ms it leaves out the device's idle gaps
    between launches that the host sends more slowly than the card runs
    them.  The profiler can lose the records of the first launches after it
    starts, so each profile opens with a few spin kernels, which are left
    out of the sum by name.  A lossy profile prints no number: a count of
    records that iters does not divide, or a time below 0.8 of event_ms (the
    CUDA-event time of the same call, given for one-launch calls that keep the
    card busy), is profiled again, and the third time the result is None,
    which the lines below print as "not measured".  The run does not fail for it: the
    kernels' checks and the times in the `kernels` line come from CUDA
    events, and this device time stands beside them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                torch.cuda._sleep(2000)
            torch.cuda.synchronize()
            time.sleep(0.01)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.name]
        ms = sum(spans) / iters / 1e3
        if (spans and len(spans) % iters == 0
                and (event_ms is None or ms >= 0.8 * event_ms)):
            return ms
        print(f"[profile] device_ms attempt {attempt + 1}: {len(spans)} "
              f"device records for {iters} calls, {ms:.4f} ms per call"
              + ("" if event_ms is None
                 else f" against {event_ms:.4f} ms by CUDA events"))
    print("[profile] device_ms: the profiler lost device records in three "
          "profiles running: device time not measured")
    return None


def _ms(value, digits=4):
    """A time for a printed line, or the words for one that was not taken."""
    return "not measured" if value is None else f"{value:.{digits}f}"


def _share(bound_ms, ms):
    """bound_ms as a percentage of ms, for a printed line."""
    return "not measured" if ms is None else f"{bound_ms / ms * 100:.2f}%"


def _sorted_features(torch, scatter, gridcoords, clouds, C, gen):
    """Cell-sorted (B, N, C) features and plan for clouds binned on the
    encoder's 64^3 grid, as LocalPoolPointnet bins them."""
    p = torch.as_tensor(clouds, device="cuda") / 2.0
    ids = gridcoords.coordinate2index(
        gridcoords.normalize_3d_coordinate(p, 0.1), 64)
    plan = scatter.pool_plan(ids)
    cs = torch.randn(p.shape[0], p.shape[1], C, device="cuda", generator=gen)
    return cs, plan


def phase_segment_pool(torch, clouds, batch, seed):
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
        "train_Xct_B8_N16384": batch["Xct"],
        "train_Xbd_B8_N32768": batch["Xbd"],
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

    # timing at the serving path's shape: B=1, N=16384, C=32, f32, mode max
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
              f"kernel_ms={_ms(dev[0], 5)} plain_ms={_ms(dev[1], 5)} "
              f"library_ms={_ms(dev[2], 5)} "
              f"({_share(bound_ms, dev[0])} of bound)")
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
        c_cpu, _, _, others = rep.get_indices(x, stage="test")
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
    phase_profile(torch, "request 1 again",
                  lambda: serve.complete(sf, clouds[:1], "request0", **kw))
    return launches


def phase_profile(torch, label, fn):
    """fn() once more under torch.profiler (after the main path's counts
    were read): the device's busy share of the wall time and the kernels
    that take it, by summed device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    print(f"[profile] {label} under the profiler: wall_ms="
          f"{wall_us / 1e3:.2f} device_busy_ms={busy / 1e3:.2f} "
          f"idle_share={1 - busy / wall_us:.4f} kernels={len(spans)}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {us / 1e3:9.2f} ms  {name[:100]}")


ATTENTION_KERNELS = {
    # name: (launch-count key, products of the function, pallas_call line in
    # jax/experimental/pallas/ops/tpu/flash_attention.py)
    "attention_fwd": ("fwd", 2, 758),
    "attention_bwd_dkv": ("dkv", 4, 1121),
    "attention_bwd_dq": ("dq", 3, 1456),
}


def _attention_bounds(torch, key_valid, H, D, elem):
    """{kernel: (bound_ms, bound_by, ops, bytes)} for f32 arithmetic on this
    run's key mask.  Operations: 2 * D per attended (query, key) pair, head
    and product, the pairs counted from key_valid.  Bytes: every input read
    and every output written once (elem bytes per q, k, v, o, d_out and
    gradient element; f32 row statistics; one byte per key of the mask)."""
    B, T = key_valid.shape
    pairs = int(torch.cumsum(key_valid.long(), dim=1).sum())
    full, row, mask = B * T * H * D * elem, B * H * T * 4, B * T
    n_bytes = {"attention_fwd": 4 * full + row + mask,
               "attention_bwd_dkv": 6 * full + 2 * row + mask,
               "attention_bwd_dq": 6 * full + 2 * row + mask}
    out = {}
    for name, (_, products, _) in ATTENTION_KERNELS.items():
        ops = 2 * products * H * D * pairs
        ops_ms = ops / F32_OPS_PER_S * 1e3
        bytes_ms = n_bytes[name] / HBM_BYTES_PER_S * 1e3
        out[name] = (max(ops_ms, bytes_ms),
                     "operations" if ops_ms >= bytes_ms else "bytes", ops,
                     n_bytes[name])
    return out, pairs


def phase_attention(torch, key_valid, seed):
    """The three attention kernels against their plain versions at the
    training shape, then their times.  Stated tolerances: f32 rtol 1e-4,
    atol 1e-5 (another summation order); bf16 2^-7 of the tensor's largest
    value (one rounding of the result).  Returns {kernel: stats}."""
    from shapeformer_tpu_torch.ops.attention import (
        CausalAttention, attention_backward_plain, attention_plain)
    F = torch.nn.functional
    B, T = key_valid.shape
    H, D = 16, 64
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    op = CausalAttention()

    def inputs(dtype):
        qkv = torch.randn(B, T, 3 * H * D, device="cuda",
                          generator=gen).to(dtype)
        q, k, v = (x.view(B, T, H, D) for x in qkv.split(H * D, dim=-1))
        d_out = torch.randn(B, T, H, D, device="cuda",
                            generator=gen).to(dtype)
        return q, k, v, d_out

    def close(got, want, dtype, what):
        got, want = got.float(), want.float()
        tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else
               dict(rtol=2 ** -7, atol=2 ** -7 * float(want.abs().max())))
        torch.testing.assert_close(got, want, msg=lambda m: f"{what}: {m}",
                                   **tol)
        return float((got - want).abs().max())

    errs = {name: 0.0 for name in ATTENTION_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, d_out = inputs(dtype)
        for label, valid in (("key_valid", key_valid), ("all_valid", None)):
            o, lse = op.forward(q, k, v, valid)
            o_want, lse_want = attention_plain(q, k, v, valid)
            want = attention_backward_plain(q, k, v, valid, o_want, lse_want,
                                            d_out)
            dq, delta = op.backward_dq(q, k, v, valid, o_want, lse_want,
                                       d_out)
            dk, dv = op.backward_dkv(q, k, v, valid, d_out, lse_want, delta)
            torch.cuda.synchronize()
            what = f"{label} {str(dtype)[6:]}"
            e = {"attention_fwd": max(
                     close(o, o_want, dtype, f"attention_fwd O {what}"),
                     close(lse, lse_want, torch.float32,
                           f"attention_fwd L {what}")),
                 "attention_bwd_dq": close(dq, want[0], dtype,
                                           f"attention_bwd_dq {what}"),
                 "attention_bwd_dkv": max(
                     close(dk, want[1], dtype, f"attention_bwd_dkv dK {what}"),
                     close(dv, want[2], dtype,
                           f"attention_bwd_dkv dV {what}"))}
            for name, err in e.items():
                if dtype == torch.float32:
                    errs[name] = max(errs[name], err)
                print(f"[kernel] {name} B{B} T{T} H{H} D{D} {what}: "
                      f"max_abs_err={err:.3e}")
            del o, lse, o_want, lse_want, want, dq, delta, dk, dv

    # times at the main path's inputs: key_valid of the batch, packed views
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, d_out = inputs(dtype)
        o, lse = attention_plain(q, k, v, key_valid)
        _, delta = op.backward_dq(q, k, v, key_valid, o, lse, d_out)
        mask = (torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
                & key_valid[:, None, None, :])
        ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        lib_err = float((lib_out.detach().transpose(1, 2).float()
                         - o.float()).abs().max())
        do_l = d_out.transpose(1, 2)

        def plain_bwd():
            return attention_backward_plain(q, k, v, key_valid, o, lse, d_out)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), do_l,
                                       retain_graph=True)
        fns = {
            "attention_fwd": (
                lambda: op.forward(q, k, v, key_valid),
                lambda: attention_plain(q, k, v, key_valid),
                lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                       attn_mask=mask)),
            "attention_bwd_dkv": (
                lambda: op.backward_dkv(q, k, v, key_valid, d_out, lse,
                                        delta), plain_bwd, lib_bwd),
            "attention_bwd_dq": (
                lambda: op.backward_dq(q, k, v, key_valid, o, lse, d_out),
                plain_bwd, lib_bwd),
        }
        bounds, pairs = _attention_bounds(torch, key_valid, H, D,
                                          q.element_size())
        tag = str(dtype)[6:]
        print(f"[kernel] attention {tag}: {pairs} attended pairs of "
              f"{B * T * (T + 1) // 2} causal; library output differs from "
              f"plain by {lib_err:.3e}; plain_ms and library_ms of the two "
              f"backward kernels are the whole backward (dQ, dK and dV in "
              f"one call)")
        for name, (kernel, plain, library) in fns.items():
            ev = [time_ms(torch, f, n) for f, n in
                  ((kernel, 20), (plain, 5), (library, 20))]
            # only the hand kernel is one launch that keeps the card busy:
            # the library's bf16 backward is a few short kernels whose event
            # time follows the host, so its device time may well be lower
            dev = [device_ms(torch, kernel, 5, event_ms=ev[0]),
                   device_ms(torch, plain, 5), device_ms(torch, library, 5)]
            bound_ms, bound_by, ops, n_bytes = bounds[name]
            print(f"[kernel] {name} B{B} T{T} H{H} D{D} {tag}: "
                  f"kernel_ms={ev[0]:.4f} plain_ms={ev[1]:.4f} "
                  f"library_ms={ev[2]:.4f}; device time (profiler) "
                  f"kernel_ms={_ms(dev[0])} plain_ms={_ms(dev[1])} "
                  f"library_ms={_ms(dev[2])}; f32 bound_ms={bound_ms:.4f} by "
                  f"{bound_by} ({ops} operations, {n_bytes} bytes, "
                  f"{_share(bound_ms, ev[0])} of bound and "
                  f"{ops / ev[0] / 1e9:.2f} TFLOP/s by CUDA events)")
            if dtype == torch.float32:
                stats[name] = dict(ms=ev[0], plain_ms=ev[1], library_ms=ev[2],
                                   device_ms=dev[0], bound_ms=bound_ms,
                                   bound_by=bound_by,
                                   max_abs_err=errs[name])
        del lib_out, ql, kl, vl, mask
    print(f"[kernel] attention comparison launches (not counted on the main "
          f"path): {op.launches}")
    return stats


def _train_batch(np, rng, batch_size, context_n, boundary_n):
    from shapeformer_tpu_torch.data.synthetic import training_pair
    pairs = [training_pair(rng, context_n, boundary_n)
             for _ in range(batch_size)]
    return dict(Xct=np.stack([p[0] for p in pairs]),
                Xbd=np.stack([p[1] for p in pairs]))


def _kernel_counts(system):
    """Launch counts of the four kernels as one dict."""
    counts = dict(system.model.transformer.attention.launches)
    counts["segment_pool"] = (
        system.model.representer.vqdif.encoder.segment_pool.launches)
    return counts


def phase_train(torch, system, batch, seed):
    """TRAIN_STEPS train steps and one eval step at flagship width.  Returns
    the kernels' launch counts over exactly these steps."""
    import math
    tf = system.model.transformer
    n_blocks = sum(tf.n_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    start = {k: p.detach().clone() for k, p in tf.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    tf.attention.reset_launches()           # counts of the main path only
    system.model.representer.vqdif.encoder.segment_pool.launches = 0
    want_step = dict(fwd=n_blocks, dkv=n_blocks, dq=n_blocks, segment_pool=8)
    for step in range(TRAIN_STEPS):
        before = _kernel_counts(system)
        clock = PhaseClock(torch)
        t0 = time.perf_counter()
        out = system.train_step(batch, gen, on_phase=clock)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        grew = {k: v - before[k] for k, v in _kernel_counts(system).items()}
        loss = float(out["loss"])
        grads = {k: p.grad for k, p in tf.named_parameters()}
        bad = [k for k, g in grads.items()
               if g is None or not bool(torch.isfinite(g).all())
               or not bool(g.any())]
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()])))
        tm = clock.times
        print(f"[train] step {step + 1}: tokenize_ms={tm['tokenize']:.2f} "
              f"forward_ms={tm['forward']:.2f} "
              f"backward_ms={tm['backward']:.2f} "
              f"optimizer_ms={tm['optimizer']:.2f} total_ms={total_ms:.2f} "
              f"loss={loss:.5f} grad_norm={norm:.5f} lr={out['lr']:.3e} "
              f"peak_GiB={torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
              f"launches=+{grew}")
        if not math.isfinite(loss):
            raise AssertionError(f"step {step + 1}: loss {loss}")
        if step == 0 and abs(loss - math.log(4097)) > 1.5:
            raise AssertionError(f"first loss {loss} is not within 1.5 of "
                                 f"ln 4097 = {math.log(4097):.3f}")
        if bad:
            raise AssertionError(f"step {step + 1}: missing, non-finite or "
                                 f"all-zero gradient for {bad[:5]}")
        if grew != want_step:
            raise AssertionError(f"step {step + 1}: kernels ran {grew}, "
                                 f"expected {want_step}")
    stuck = [k for k, p in tf.named_parameters()
             if torch.equal(p.detach(), start[k])]
    if stuck:
        raise AssertionError(f"parameters did not change: {stuck[:5]}")
    del start
    before = _kernel_counts(system)
    clock = PhaseClock(torch)
    ev = system.eval_step(batch)
    clock("eval")
    grew = {k: v - before[k] for k, v in _kernel_counts(system).items()}
    print(f"[train] eval step: eval_ms={clock.times['eval']:.2f} "
          f"loss={float(ev['loss']):.5f} launches=+{grew}")
    if not math.isfinite(float(ev["loss"])):
        raise AssertionError("eval loss is not finite")
    if grew != dict(fwd=n_blocks, dkv=0, dq=0, segment_pool=8):
        raise AssertionError(f"eval step: kernels ran {grew}")
    launches = _kernel_counts(system)       # read right after the main path
    phase_profile(torch, "one more train step",
                  lambda: system.train_step(batch, gen))
    return launches


def phase_whole_path(torch, system, batch, seed):
    """One loss-and-gradient pass of 2 examples with the attention kernels
    and one with torch-op attention, same weights, batch and draws: loss at
    rtol 1e-5, every gradient leaf max|diff| <= 1e-3 * max|g|."""
    tf = system.model.transformer
    small = system.device_batch({k: v[:2] for k, v in batch.items()})
    res = {}
    for flash in (True, False):
        tf.flash_attn = flash
        tf.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(seed + 7)
        loss = system.model.loss(small, gen, stage="train")
        loss.backward()
        torch.cuda.synchronize()
        res[flash] = (float(loss.detach()),
                      {k: p.grad.clone() for k, p in tf.named_parameters()})
    tf.flash_attn = True
    tf.zero_grad(set_to_none=True)
    (l_k, g_k), (l_t, g_t) = res[True], res[False]
    worst, worst_name = 0.0, ""
    for name, g in g_k.items():
        ratio = float((g - g_t[name]).abs().max()
                      / g_t[name].abs().max().clamp(min=1e-30))
        if ratio > worst:
            worst, worst_name = ratio, name
    print(f"[whole] B=2 kernels vs torch-op attention: loss {l_k:.6f} vs "
          f"{l_t:.6f} (rel {abs(l_k - l_t) / abs(l_t):.2e}); worst gradient "
          f"leaf {worst_name}: max|diff| / max|g| = {worst:.3e} over "
          f"{len(g_k)} leaves")
    if abs(l_k - l_t) > 1e-5 * abs(l_t):
        raise AssertionError("kernel and torch-op losses differ")
    if worst > 1e-3:
        raise AssertionError(f"gradient leaf {worst_name} differs by "
                             f"{worst:.3e} of its largest value")


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
    from shapeformer_tpu_torch import configs, systems
    train = configs.TRAIN
    batch = _train_batch(np, rng, train["batch_size"], train["context_N"],
                         train["boundary_N"])
    kstats, max_err = phase_segment_pool(torch, clouds, batch, args.seed)
    serve_launches = phase_slice(torch, clouds, args.seed)
    if serve_launches == 0:
        raise AssertionError("segment_pool never ran on the serving path")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    system = systems.build_trainer("cuda", seed=args.seed)
    tkw = systems.train_options()["transformer_opt"]["kwargs"]
    print(f"[train] trainer built in {time.perf_counter() - t0:.2f} s: "
          f"batch {train['batch_size']}, Xct {batch['Xct'].shape}, Xbd "
          f"{batch['Xbd'].shape}, flash_attn={tkw['flash_attn']}, dropouts "
          f"{tkw['embd_pdrop']}/{tkw['resid_pdrop']}/{tkw['attn_pdrop']}")
    with torch.no_grad():
        rep = system.model.representer
        c, z, _, _ = rep.get_indices(
            **system.device_batch(batch), stage="val")
        key_valid = torch.cat([rep.cond_token_mask(c),
                               rep.cond_token_mask(z)], dim=1)[:, :-1]
    print(f"[train] token sequences: condition lengths "
          f"{rep.cond_token_mask(c).sum(1).tolist()}, target lengths "
          f"{rep.cond_token_mask(z).sum(1).tolist()} of {c.shape[1]} "
          f"(end token included)")
    astats = phase_attention(torch, key_valid.contiguous(), args.seed)
    train_launches = phase_train(torch, system, batch, args.seed)
    phase_whole_path(torch, system, batch, args.seed)
    print(f"[summary] main-path launches: serving {N_REQUESTS} requests "
          f"segment_pool={serve_launches}; training {TRAIN_STEPS} train "
          f"steps + 1 eval step {train_launches}")

    rows = [dict(name="segment_pool", route="cuda",
                 source="shapeformer_tpu_torch/csrc/segment_pool.cu",
                 replaces="shapeformer_tpu/ops/pallas_scatter.py:69",
                 launches=serve_launches + train_launches["segment_pool"],
                 max_abs_err=max_err, ms=kstats["ms"],
                 plain_ms=kstats["plain_ms"], bound_ms=kstats["bound_ms"],
                 bound_by=kstats["bound_by"],
                 library_ms=kstats["library_ms"])]
    for name, (key, _, line) in ATTENTION_KERNELS.items():
        st = astats[name]
        if train_launches[key] == 0:
            raise AssertionError(f"{name} never ran on the training path")
        rows.append(dict(
            name=name, route="cuda",
            source="shapeformer_tpu_torch/csrc/attention.cu",
            replaces=("shapeformer_tpu/models/shapeformer/transformer/"
                      "mingpt.py:94"),
            pallas_call=("jax/experimental/pallas/ops/tpu/"
                         f"flash_attention.py:{line}"),
            launches=train_launches[key], max_abs_err=st["max_abs_err"],
            ms=st["ms"], plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by=st["bound_by"], library_ms=st["library_ms"],
            device_ms=st["device_ms"]))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
