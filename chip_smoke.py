#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this checkout's ``src/repro_torch``; it
exits non-zero without printing a result when any of them is missing.
Phases, each of which must pass:

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   every kernel, all sources at once, timed, with ptxas's registers and
   spills;
2. ``kd_loss`` against its plain PyTorch version on the card, at the
   exchange path's largest shape and at large vocabularies, f32 and
   bf16, plus the gradient of the fused loss against plain autograd;
3. the exchange path: the model-exchange cycle at the ``exchange_scale``
   configuration (10,000 LR/MLP parties), with every kernel's launch
   count reset just before and read just after; then ``kd_loss`` against
   its plain version at every shape that run gave it;
4. a small seeded exchange run on the card and on the host from one
   state: identical event logs and cycle counts, losses within 1e-5;
5. ``kd_loss`` kernel, plain-version and bound times;
6. ``flash_attention`` against its plain version at the serve path's
   shape, a 4096-token prefill, a 1024 window, non-causal, a ragged S
   and head_dim 64 and 80, f32 (tol 2e-5) and bf16 (tol 2e-2);
7. the serve path: ``repro_torch.launch.serve.main`` serving Qwen2-1.5B
   at full width and depth (16 requests x 32 new tokens, slots of 8),
   counts reset just before and read just after; flash launches must be
   slots x 28 and every logit finite; then the kernel against its plain
   version on the q/k/v that run gave it;
8. the serve path's last (warm) slot again, with its params and steps,
   under ``torch.profiler``: device kernel time of prefill and decode
   against that slot's walls, and the flash kernel's share;
9. one set of params at full width and vocab, 2 layers, f32, served on
   the card and on the host: identical greedy tokens, last-step logits
   within 2e-4;
10. ``flash_attention`` kernel, plain, bound and SDPA times, bf16 causal,
    at the serve shape and at (1,12,4096,128).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the float32 (non-tensor
# core) peak, both at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the dense bf16 tensor-core peak (same data sheet)
BF16_OPS_PER_S = 989e12
# arithmetic the function needs per (student, teacher) logit pair: three
# exponentials, two temperature scalings, three max/subtract, four sums
OPS_PER_LOGIT = 12
KD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
QWEN2_VOCAB = 151936  # configs/qwen2_1_5b.py


def log(msg: str = "") -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- kd_loss checks ------------------------------------------------------------
def kd_inputs(n, v, dtype, seed, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    s = (2 * torch.randn(n, v, generator=g, device=device)).to(dtype)
    t = (2 * torch.randn(n, v, generator=g, device=device)).to(dtype)
    lab = torch.randint(0, v, (n,), generator=g, device=device,
                        dtype=torch.int32)
    return s, t, lab


def check_close(name, out, ref, tol):
    err = (out - ref).abs()
    bad = err > tol + tol * ref.abs()
    max_err = float(err.max())
    if not torch.isfinite(out).all() or bool(bad.any()):
        raise AssertionError(f"{name}: max |err| {max_err:.3e} over tol {tol}")
    return max_err


def kd_check(kd, n, v, dtype, seed, alpha=0.3, temperature=2.0):
    s, t, lab = kd_inputs(n, v, dtype, seed)
    out = kd.kd_loss(s, t, lab, alpha=alpha, temperature=temperature)
    ref = kd.kd_loss_plain(s, t, lab, alpha=alpha, temperature=temperature)
    torch.cuda.synchronize()
    err = check_close(f"kd_loss {n}x{v} {dtype}", out, ref, KD_TOL[dtype])
    log(f"kd_loss {n}x{v} {str(dtype)[6:]}: max|kernel-plain| {err:.3e} "
        f"(tol {KD_TOL[dtype]})")
    return err


def kd_self_check(kd, n=200, v=QWEN2_VOCAB, alpha=0.7, temperature=3.0):
    """teacher == student: the KL term vanishes, loss = alpha * CE."""
    s, _, lab = kd_inputs(n, v, torch.float32, 11)
    out = kd.kd_loss(s, s, lab, alpha=alpha, temperature=temperature)
    ce = torch.logsumexp(s, -1) - s.gather(-1, lab.long()[:, None])[:, 0]
    torch.cuda.synchronize()
    err = check_close("kd_loss teacher==student", out, alpha * ce, 1e-4)
    log(f"kd_loss teacher==student {n}x{v}: max|kernel-alpha*CE| {err:.3e}")
    return err


def grad_check(losses, k, b, v, seed, alpha=0.5, temperature=2.0):
    """d(sum of per-party fused means)/d(student) vs plain autograd."""
    s, t, lab = kd_inputs(k * b, v, torch.float32, seed)
    s, t, lab = s.view(k, b, v), t.view(k, b, v), lab.view(k, b)
    sf = s.clone().requires_grad_(True)
    losses.fused_distillation_loss(sf, t, lab, alpha, temperature).sum() \
        .backward()
    sp = s.clone().requires_grad_(True)
    plain = sum(losses.distillation_loss(sp[i], t[i], lab[i], alpha=alpha,
                                         temperature=temperature)[0]
                for i in range(k))
    plain.backward()
    torch.cuda.synchronize()
    err = check_close(f"fused grad {k}x{b}x{v}", sf.grad, sp.grad, 1e-5)
    log(f"fused_distillation_loss grad {k}x{b}x{v}: max|kernel-plain| "
        f"{err:.3e} (tol 1e-5)")
    return err


# -- the main path ---------------------------------------------------------------
def party_data(n_parties, n_per_party, n_feat, n_classes, seed):
    """Shared linear concept; per-party label noise => accuracy spread
    (the data of benchmarks/exchange_scale.py)."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(n_feat, n_classes)).astype(np.float32)
    x = rng.normal(size=(n_parties, n_per_party, n_feat)).astype(np.float32)
    y_clean = (x @ w_true).argmax(-1)
    noise = rng.uniform(0.0, 0.6, size=n_parties)
    flip = rng.random((n_parties, n_per_party)) < noise[:, None]
    y = np.where(flip, rng.integers(0, n_classes, y_clean.shape), y_clean)
    ex = rng.normal(size=(256, n_feat)).astype(np.float32)
    ey = (ex @ w_true).argmax(-1)
    return x, y.astype(np.int32), ex, ey.astype(np.int32)


def build_cohorts(n_parties, device, seed=0, mlp_frac=0.2, n_feat=16,
                  n_classes=8, n_per_party=64):
    from repro_torch.models.small import make_lr, make_mlp
    from repro_torch.runtime.exchange import split_cohorts
    from repro_torch.runtime.population import PartyPopulation

    x, y, ex, ey = party_data(n_parties, n_per_party, n_feat, n_classes, seed)
    n_lr, n_mlp = split_cohorts(n_parties, mlp_frac)
    cohorts = [
        PartyPopulation(make_lr(n_feat, n_classes), x[:n_lr], y[:n_lr],
                        task="exchange_bench", lr=0.1, batch_size=32,
                        seed=seed, party_ids=[f"lr{i}" for i in range(n_lr)],
                        device=device),
        PartyPopulation(make_mlp(n_feat, n_classes, hidden=32), x[n_lr:],
                        y[n_lr:], task="exchange_bench", lr=0.1,
                        batch_size=32, seed=seed + 1,
                        party_ids=[f"mlp{i}" for i in range(n_mlp)],
                        device=device),
    ]
    return cohorts, ex, ey


def exchange(cohorts, ex, ey, cycles, edges, device, seed=0, on_cycle=None):
    from repro_torch.core.continuum import Continuum
    from repro_torch.core.incentives import IncentiveLedger
    from repro_torch.heterogeneity.availability import markov_trace
    from repro_torch.runtime.exchange import ExchangeConfig, run_exchange

    traces = [markov_trace(pop.num_parties, horizon=max(cycles, 8),
                           seed=seed + 7 * k)
              for k, pop in enumerate(cohorts)]
    cont = Continuum(ledger=IncentiveLedger())
    for e in range(edges):
        cont.add_edge_server(f"edge{e:03d}")
    report = run_exchange(cohorts, ex, ey,
                          cfg=ExchangeConfig(cycles=cycles, distill_epochs=1),
                          continuum=cont, availabilities=traces,
                          on_cycle=on_cycle, device=device)
    cont.ledger.assert_conserved()
    return report, cont


PHASES = ("train_epochs", "evaluate", "all_party_params", "distill_batch")


def timed(fn, name, totals):
    """``fn`` with its wall time, up to a device sync, added to totals."""
    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[name] += time.perf_counter() - t
        return out
    return wrapper


def reset_counts(kernels):
    for mod in kernels:
        mod.launches = 0


def main_path(kernels, cycles):
    """10,000 parties x ``cycles`` on the card; returns kd_loss launches
    and the shapes it was given."""
    kd = kernels[0]
    cohorts, ex, ey = build_cohorts(10_000, "cuda")
    log(f"cohorts: {[(p.model.name, p.num_parties) for p in cohorts]}")
    shapes = set()
    kd_loss = kd.kd_loss
    phase_s = dict.fromkeys(PHASES, 0.0)
    for pop in cohorts:
        for name in PHASES:
            setattr(pop, name, timed(getattr(pop, name), name, phase_s))

    def recording(student_logits, teacher_logits, labels, **kw):
        shapes.add((tuple(student_logits.shape), student_logits.dtype))
        return kd_loss(student_logits, teacher_logits, labels, **kw)

    marks = []
    t0 = time.perf_counter()

    def on_cycle(stats):
        torch.cuda.synchronize()
        marks.append((stats.cycle, time.perf_counter() - t0))
        log(f"  {stats}")

    kd.kd_loss = recording  # what the loss module calls, by attribute
    try:
        reset_counts(kernels)
        t0 = time.perf_counter()
        report, _ = exchange(cohorts, ex, ey, cycles, edges=32,
                             device="cuda", on_cycle=on_cycle)
        torch.cuda.synchronize()
        launches = kd.launches
        counts = {m.__name__: m.launches for m in kernels}
    finally:
        kd.kd_loss = kd_loss
    wall = time.perf_counter() - t0
    ends = {}
    for c, w in marks:
        ends[c] = max(ends.get(c, 0.0), w)
    prev, per_cycle = 0.0, []
    for c in sorted(ends):
        per_cycle.append(ends[c] - prev)
        prev = ends[c]
    fetched = report.total_fetches
    cross = report.total_cross_arch
    log(f"exchange 10000 parties x {cycles} cycles: wall {wall:.2f} s, per "
        f"cycle {[round(w, 2) for w in per_cycle]} s, events "
        f"{report.events}, fetched {fetched}, cross_arch {cross}, "
        f"launches {counts}")
    rest = wall - sum(phase_s.values())
    log("wall by phase (s, summed over cohorts, each phase ends in a "
        "device sync): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     phase_s.items())
        + f", rest (event loop, serde, vault, discovery, ledger, teacher "
          f"stacking) {rest:.3f}")
    led = report.ledger
    log(f"ledger: minted {led.get('minted', 0):.1f} operator "
        f"{led.get('operator', 0):.1f} denied {led.get('denied', 0)} "
        "(conserved)")
    assert launches > 0, "the main path launched no kd_loss kernel"
    assert fetched > 0 and cross > 0, (fetched, cross)
    for s in report.cycles:
        assert np.isfinite(s.distill_loss) and 0.0 <= s.mean_acc <= 1.0, s
    return launches, sorted(shapes, key=lambda t: t[0])


def cuda_vs_cpu(n_parties=64, cycles=2):
    """One seeded state, run on the card and on the host."""
    from repro_torch.convert import state_from_reference

    runs = {}
    start = None
    for device in ("cpu", "cuda"):
        cohorts, ex, ey = build_cohorts(n_parties, device, seed=3)
        if start is None:
            start = [p.export_state() for p in cohorts]
        for pop, snap in zip(cohorts, start):
            pop.restore_state(state_from_reference(snap, device))
        runs[device] = exchange(cohorts, ex, ey, cycles, edges=4,
                                device=device, seed=3)
    (rc, cc), (rg, cg) = runs["cpu"], runs["cuda"]
    log_c = [(r.label, r.time, r.payload) for r in cc.loop.log]
    log_g = [(r.label, r.time, r.payload) for r in cg.loop.log]
    if log_c != log_g:
        first = next(i for i, (a, b) in enumerate(zip(log_c, log_g)) if a != b)
        raise AssertionError(f"event logs differ at event {first}: "
                             f"{log_c[first]} vs {log_g[first]}")
    worst = 0.0
    for a, b in zip(rc.cycles, rg.cycles):
        for f in ("cohort", "cycle", "online", "published", "fetched",
                  "denied", "misses", "cross_arch", "failed",
                  "teacher_fetches", "mean_acc", "best_acc"):
            assert getattr(a, f) == getattr(b, f), (f, a, b)
        worst = max(worst, abs(a.distill_loss - b.distill_loss))
    assert len(rc.cycles) == len(rg.cycles) and worst <= 1e-5, worst
    assert rc.ledger == rg.ledger
    log(f"cuda vs cpu exchange {n_parties} parties x {cycles} cycles: "
        f"{len(log_c)} identical events, identical cycle counts, max "
        f"|distill_loss diff| {worst:.3e}, identical ledger")


# -- flash_attention and the serve path ------------------------------------------
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
# (B, H, KV, S, hd, causal, window): the serve path's prefill, a long
# prefill, a sliding window, non-causal, a ragged S, head_dim 64 and 80
FA_SHAPES = [
    (8, 12, 2, 32, 128, True, None),
    (1, 12, 2, 4096, 128, True, None),
    (1, 12, 2, 4096, 128, True, 1024),
    (1, 12, 2, 2048, 128, False, None),
    (2, 12, 2, 1000, 128, True, None),
    (2, 8, 2, 1024, 64, True, None),
    (2, 32, 32, 512, 80, True, None),
]
SERVE_ARGS = ["--arch", "qwen2_1_5b", "--requests", "16", "--max-batch", "8",
              "--bucket", "32", "--max-new", "32"]
# card vs host at full width and vocab, 2 layers in float32: float32
# products without TF32 on both sides, so logits differ only by summation
# order; 2e-4 is the reference's own float32 logit tolerance
# (tests/test_models.py:85)
HOST_TOL = 2e-4


def fa_inputs(B, H, KV, S, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


def fa_check(fa, q, k, v, causal, window, label):
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = FA_TOL[q.dtype]
    err = check_close(f"flash_attention {label}", out.float(), ref.float(),
                      tol)
    log(f"flash_attention {label} {str(q.dtype)[6:]}: max|kernel-plain| "
        f"{err:.3e} (tol {tol})")
    return err


def fa_shape_label(B, H, KV, S, hd, causal, window):
    return (f"q ({B},{H},{S},{hd}) kv ({B},{KV},{S},{hd}) "
            f"{'causal' if causal else 'non-causal'}"
            + (f" window {window}" if window is not None else ""))


def serve_path(kernels):
    """Qwen2-1.5B at full width on the card through serve.main; returns
    the flash launches, the first prefill q/k/v it was given, and the last
    slot's ``run_slot`` arguments and prefill / decode walls."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    fa = kernels[1]
    cfg = get_config("qwen2_1_5b")
    slots, calls, last = [], [], {}
    run_slot, flash = serve.run_slot, fa.flash_attention

    def recording_slot(*args, **kw):
        out = run_slot(*args, **kw)
        _, logits, tp, td = out
        slots.append((bool(torch.isfinite(logits.float()).all()), tp, td))
        last["args"] = args
        return out

    def recording_flash(q, k, v, **kw):
        if not calls:
            calls.append((q.clone(), k.clone(), v.clone(), kw))
        return flash(q, k, v, **kw)

    serve.run_slot, fa.flash_attention = recording_slot, recording_flash
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        t0 = time.perf_counter()
        rc = serve.main(SERVE_ARGS)
        torch.cuda.synchronize()
        launches = fa.launches
        counts = {m.__name__: m.launches for m in kernels}
    finally:
        serve.run_slot, fa.flash_attention = run_slot, flash
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    requests, max_new = 16, 32
    t_prefill = sum(sl[1] for sl in slots)
    t_decode = sum(sl[2] for sl in slots)
    log(f"serve qwen2_1_5b ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}): {len(slots)} slots, wall "
        f"{wall:.2f} s (params init included), prefill {t_prefill:.4f} s, "
        f"decode {t_decode:.4f} s, {requests * max_new / t_decode:.1f} tok/s "
        f"batch-aggregate, peak {peak / 2**30:.2f} GiB, launches {counts}; "
        f"per slot prefill {[round(sl[1], 4) for sl in slots]} s, decode "
        f"{[round(sl[2], 4) for sl in slots]} s")
    assert rc == 0, rc
    assert all(sl[0] for sl in slots), "non-finite logits"
    assert launches == len(slots) * cfg.num_layers > 0, (launches, len(slots))
    assert len(slots) > 1, "no warm slot to break down"
    return launches, calls[0], last["args"], slots[-1][1:]


def serve_breakdown(fa, slot_args, walls, profiled_steps=4):
    """Where the serve path's last (warm) slot spent its time: its prefill
    and decode walls from the serve run, and the device's kernel time, the
    flash kernel's part and the top kernels from the same slot's prefill
    and first decode steps, with its params, run again under the profiler.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    cfg, prefill, step, params, prompts, bucket, max_new = slot_args
    t_prefill, t_decode = walls
    batch = len(prompts)
    tokens = serve.pad_batch(cfg, prompts, bucket, "cuda")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    launches = fa.launches
    with torch.inference_mode():
        with profile(activities=activities) as prof_prefill:
            logits, cache = prefill(params, tokens)
            torch.cuda.synchronize()
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        with profile(activities=activities) as prof_decode:
            for _ in range(profiled_steps):
                nxt, logits, cache = step(params, cache, {"token": tok})
                tok = nxt[:, None]
            torch.cuda.synchronize()
    fa.launches = launches  # profiling launches are not the main path's

    def device_us(prof):
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + \
                    e.time_range.elapsed_us()
        return by_name

    pre, dec = device_us(prof_prefill), device_us(prof_decode)
    pre_ms, dec_ms = sum(pre.values()) / 1e3, sum(dec.values()) / 1e3
    flash_ms = sum(v for k, v in pre.items() if "flash_fwd" in k) / 1e3
    steps = max_new - 1
    dec_ms *= steps / profiled_steps  # device time of all the slot's steps
    top = sorted(dec.items(), key=lambda kv: -kv[1])[:5]
    log(f"serve breakdown, the last (warm) slot, {batch} x bucket {bucket}: "
        f"prefill wall {t_prefill * 1e3:.3f} ms, device kernel time "
        f"{pre_ms:.3f} ms ({pre_ms / (t_prefill * 1e3):.1%} of the wall), "
        f"flash kernel {flash_ms:.3f} ms ({flash_ms / (t_prefill * 1e3):.1%} "
        f"of the prefill wall, {flash_ms / pre_ms:.1%} of its device time)")
    log(f"serve breakdown: decode wall {t_decode * 1e3 / steps:.3f} ms a "
        f"step over {steps} steps, device kernel time "
        f"{dec_ms / steps:.3f} ms a step ({dec_ms / (t_decode * 1e3):.1%} "
        f"busy; {profiled_steps} steps profiled), top kernels by device "
        f"time: "
        + "; ".join(f"{k[:60]} {v / 1e3 / profiled_steps:.3f} ms/step"
                    for k, v in top))
    assert flash_ms > 0, "the profiler saw no flash_attention kernel"


def serve_card_vs_host(n_requests=16, bucket=32, max_new=32, max_batch=8):
    """One set of params, 2 layers at full width, on the card and host."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.runtime.serving import SlotQueue

    cfg = get_config("qwen2_1_5b").replace(num_layers=2, dtype="float32")
    prefill, model = make_prefill_step(cfg, cache_len=bucket + max_new)
    step, _ = make_serve_step(cfg)
    host_params = model.init(torch.Generator().manual_seed(0))
    prompts = serve.make_requests(cfg, n_requests, seed=0)
    runs = {}
    for device in (torch.device("cpu"), resolve_device("cuda")):
        params = params_from_reference(host_params, device)
        queue = SlotQueue(buckets=(bucket,), max_batch=max_batch)
        for i, p in enumerate(prompts):
            queue.add("qwen2", len(p), i)
        gen = np.zeros((n_requests, max_new), np.int32)
        logits = []
        with torch.inference_mode():
            while len(queue):
                idxs = queue.drain("qwen2", bucket)
                rows, lg, _, _ = serve.run_slot(
                    cfg, prefill, step, params, [prompts[i] for i in idxs],
                    bucket, max_new)
                gen[np.asarray(idxs)] = rows
                logits.append(lg.float().cpu())
        runs[device.type] = (gen, torch.cat(logits))
    (gen_h, lg_h), (gen_c, lg_c) = runs["cpu"], runs["cuda"]
    same = (gen_h == gen_c).all(axis=1)
    err = check_close("serve logits card vs host", lg_c, lg_h, HOST_TOL)
    log(f"serve 2 layers full width f32, card vs host: {int(same.sum())}/"
        f"{n_requests} requests with identical greedy tokens ({max_new} "
        f"each), last-step logits max|diff| {err:.3e} (tol {HOST_TOL})")
    assert same.all(), np.nonzero(~same)[0]
    return err


# -- timing ----------------------------------------------------------------------
def time_ms(fn, arg_sets, iters):
    """Mean ms per call with CUDA events, cycling through ``arg_sets`` so
    that inputs come from HBM, not from the 50 MB L2."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kd_timing(kd, n, v, dtype, iters=50):
    elt = torch.finfo(dtype).bits // 8
    nbytes = 2 * n * v * elt + 4 * n + 4 * n
    copies = max(1, min(32, -(-128 * 2**20 // nbytes)))
    sets = [kd_inputs(n, v, dtype, 100 + i) for i in range(copies)]
    launches = kd.launches
    ms = time_ms(lambda s, t, lab: kd.kd_loss(s, t, lab), sets, iters)
    plain_ms = time_ms(lambda s, t, lab: kd.kd_loss_plain(s, t, lab), sets,
                       max(5, iters // 5))
    kd.launches = launches  # timing launches are not the main path's
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_LOGIT * n * v / F32_OPS_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    bound_ms = max(bytes_ms, ops_ms)
    log(f"kd_loss timing {n}x{v} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
        f"{nbytes} B), kernel at {bound_ms / ms:.1%} of bound, "
        f"{copies} input copies rotated")
    return ms, plain_ms, bound_ms, bound_by


def fa_timing(fa, B, H, KV, S, hd, dtype=torch.bfloat16, iters=20):
    """Kernel, plain and SDPA ms for causal attention at one shape, with
    the bound: max(flops / bf16 tensor peak, bytes / HBM rate), where a
    causal pass needs 2*B*H*S^2*hd flops (half of QK^T and PV) and moves
    q, k and v in once and o out once."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    elt = torch.finfo(dtype).bits // 8
    nbytes = 2 * (B * H + B * KV) * S * hd * elt
    copies = max(1, min(32, -(-128 * 2**20 // nbytes)))
    sets = [fa_inputs(B, H, KV, S, hd, dtype, 200 + i) for i in range(copies)]
    launches = fa.launches
    ms = time_ms(lambda q, k, v: fa.flash_attention(q, k, v), sets, iters)
    fa.launches = launches  # timing launches are not the main path's
    plain_ms = time_ms(lambda q, k, v: fa.flash_attention_plain(q, k, v),
                       sets, max(5, iters // 4))
    lib_ms = time_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True,
                                          enable_gqa=True), sets, iters)
    flops = 2 * B * H * S * S * hd
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    bound_ms = max(bytes_ms, ops_ms)
    log(f"flash_attention timing {fa_shape_label(B, H, KV, S, hd, True, None)}"
        f" {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
        f"{flops} flops, {nbytes} B), kernel at {bound_ms / ms:.2%} of bound, "
        f"{copies} input copies rotated")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": [B, H, KV, S, hd]}


def build_all(kernels):
    """nvcc for every kernel source at once, one process each; logs each
    build's time and the registers and spills ptxas reports."""
    def one(mod):
        t0 = time.perf_counter()
        so = mod.build()
        return so, time.perf_counter() - t0

    with ThreadPoolExecutor(len(kernels)) as pool:
        done = list(pool.map(one, kernels))
    for mod, (so, secs) in zip(kernels, done):
        log(f"nvcc build {mod.__name__.rsplit('.', 1)[-1]}: {secs:.2f} s -> "
            f"{so.relative_to(ROOT)}")
        log_path = so.with_suffix(".log")
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling entry" in line:
                    log(f"  ptxas: {line.strip()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from repro_torch.core import losses
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import kd_loss as kd
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = gpu_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    kernels = (kd, fa)

    # 1. build every kernel, in parallel
    build_all(kernels)

    # 2. kd_loss vs plain at the listed shapes
    errs = [kd_check(kd, 4096 * 32, 8, torch.float32, 1)]
    for dtype in (torch.float32, torch.bfloat16):
        for n in (200, 256):
            errs.append(kd_check(kd, n, QWEN2_VOCAB, dtype, 2 + n))
    errs.append(kd_check(kd, 131, 1000, torch.float32, 5))  # ragged N and V
    errs.append(kd_self_check(kd))
    errs.append(grad_check(losses, 4, 32, 8, 6))
    errs.append(grad_check(losses, 3, 32, 1000, 7))

    # 3. the exchange path, then kd_loss at every shape it was given
    cycles = 3
    launches, shapes = main_path(kernels, cycles)
    for (n, v), dtype in shapes:
        errs.append(kd_check(kd, n, v, dtype, 8 + n))
    log(f"main-path kd_loss shapes: {[s for s, _ in shapes]}")

    # 4. the same exchange state on the card and on the host
    cuda_vs_cpu()

    # 5. kd_loss timings
    main_n = max(n for (n, _), _ in shapes)
    ms, plain_ms, bound_ms, bound_by = kd_timing(kd, main_n, 8,
                                                 torch.float32)
    kd_timing(kd, 256, QWEN2_VOCAB, torch.float32, iters=20)
    kd_timing(kd, 256, QWEN2_VOCAB, torch.bfloat16, iters=20)
    log("library_ms: no single PyTorch call computes this fused loss, so "
        "there is no library yardstick")
    log(f"kd_loss launches per cycle on the main path: {launches / cycles}")

    # 6. flash_attention vs plain at the listed shapes, f32 and bf16
    fa_errs = []
    for B, H, KV, S, hd, causal, window in FA_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = fa_inputs(B, H, KV, S, hd, dtype, S + hd)
            label = fa_shape_label(B, H, KV, S, hd, causal, window)
            fa_errs.append(fa_check(fa, q, k, v, causal, window, label))
            del q, k, v

    # 7. the serve path at full width, then the kernel at its prefill shape
    fa_launches, (q, k, v, kw), slot_args, walls = serve_path(kernels)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    label = "serve-path " + fa_shape_label(B, H, KV, S, hd,
                                           kw["causal"], kw["window"])
    fa_errs.append(fa_check(fa, q, k, v, kw["causal"], kw["window"],
                            label + " (its own q/k/v)"))
    rq, rk, rv = fa_inputs(B, H, KV, S, hd, q.dtype, 7)
    fa_errs.append(fa_check(fa, rq, rk, rv, kw["causal"], kw["window"],
                            label))
    del q, k, v, rq, rk, rv

    # 8. where the warm slot's time went, under the profiler
    serve_breakdown(fa, slot_args, walls)
    del slot_args

    # 9. one set of params on the card and on the host, 2 layers
    serve_card_vs_host()

    # 10. flash_attention timings, bf16 causal
    fa_main = fa_timing(fa, B, H, KV, S, hd, iters=50)
    fa_long = fa_timing(fa, 1, 12, 2, 4096, 128, iters=10)
    log(f"total wall: {time.perf_counter() - t_start:.1f} s on {card}")

    print(json.dumps({"kernels": [{
        "name": "kd_loss",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kd_loss.cu",
        "replaces": "src/repro/kernels/kd_loss.py:129",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": [main_n, 8],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:104",
        "launches": fa_launches,
        "max_abs_err": max(fa_errs),
        "ms": fa_main["ms"],
        "plain_ms": fa_main["plain_ms"],
        "bound_ms": fa_main["bound_ms"],
        "bound_by": fa_main["bound_by"],
        "library_ms": fa_main["library_ms"],
        "shape": fa_main["shape"],
        "long_prefill": fa_long,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
