#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this checkout's ``src/repro_torch``; it
exits non-zero without printing a result when any of them is missing.
Phases, each of which must pass:

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   every kernel, all sources at once, timed, with ptxas's registers and
   spills (and the scan's and every flash instance's dynamic shared
   memory);
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
   shape, a 4096-token prefill, a 1024 window, non-causal, ragged S (1,
   63, 65, 129, 1000, 4095), window 0 (every row zero), head_dim 64 and
   80, and 16 query heads a KV head, f32 (tol 2e-5: the CUDA-core kernel)
   and bf16 (tol 2e-2: the wgmma kernel);
7. the Qwen2 serve path: ``repro_torch.launch.serve.main`` serving
   Qwen2-1.5B at full width and depth (16 requests x 32 new tokens,
   slots of 8), counts reset just before and read just after; flash
   launches must be slots x 28 and every logit finite; then the kernel
   against its plain version on the q/k/v that run gave it;
8. that serve run's last (warm) slot again, with its params and steps,
   under ``torch.profiler``: device kernel time of prefill and decode
   against that slot's walls, and the flash kernel's share;
9. one set of Qwen2 params at full width and vocab, 2 layers, f32, served
   on the card and on the host: identical greedy tokens, last-step logits
   within 2e-4;
10. ``flash_attention`` kernel, plain, bound and SDPA times, bf16, at the
    Qwen2 and Zamba2 serve shapes and at (1,12,4096,128) causal and with
    a 1024 window, in turns; kernel and SDPA also replayed from a CUDA
    graph, which leaves out the host's time per call;
11. ``ssd_scan`` against its plain version at the Zamba2 serve path's
    shape, a 4096-token prefill (16 chunks), a ragged S, the smoke shape
    and the shapes of tests/test_kernels.py, f32 (tol 1e-4) and bf16
    (3e-2); the long prefill also against the sequential oracle, with
    the share of ||y|| that the carried state gives;
12. the Zamba2 serve path: ``serve.main`` serving Zamba2-2.7B at full
    width and depth, as in 7; ``ssd_scan`` launches must be slots x 54
    and flash launches slots x 9; then both kernels against their plain
    versions on the inputs that run gave them;
13. that run's warm slot under the profiler, with the scan's and the
    flash kernel's shares of prefill;
14. one full-width Mamba2 layer, f32, S 1024 (4 chunks), on the card and
    on the host: output, final state and conv tail within 1e-4;
15. one set of Zamba2 params at full width and vocab, 12 layers (2
    super-blocks, so two KV caches of the shared block), f32, 8 requests
    in one slot on the card and on the host: identical greedy tokens,
    last-step logits within 2e-4;
16. ``ssd_scan`` kernel, plain and bound times, f32, at the serve shape
    and at the 4096-token prefill;
17. a Qwen2 prefill at full width, 2 layers, bf16, one slot of 8 at
    bucket 32, from one set of params, through the kernel and through its
    plain version: last-position logits within 3e-2 (the bf16 kernel
    rounds P to bf16 where the plain version keeps float32), and the
    share of greedy tokens over 32 steps that agree.

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
# prefill, a sliding window, non-causal, ragged S (one token, either side
# of the 64-token packing limit, one past a 128-row tile, one short of a
# long prefill), window 0, head_dim 64 and 80, 16 query heads a KV head
FA_SHAPES = [
    (8, 12, 2, 32, 128, True, None),
    (1, 12, 2, 4096, 128, True, None),
    (1, 12, 2, 4096, 128, True, 1024),
    (1, 12, 2, 2048, 128, False, None),
    (2, 12, 2, 1000, 128, True, None),
    (2, 12, 2, 1, 128, True, None),
    (2, 12, 2, 63, 128, True, None),
    (2, 12, 2, 65, 128, True, None),
    (1, 12, 2, 129, 128, True, None),
    (1, 12, 2, 4095, 128, True, None),
    (2, 12, 2, 300, 128, True, 0),
    (2, 8, 2, 1024, 64, True, None),
    (2, 32, 2, 512, 64, True, None),
    (4, 32, 2, 32, 64, True, None),
    (2, 32, 32, 512, 80, True, None),
]
# the four shapes phase 10 times, bf16: (B, H, KV, S, hd, window), causal
FA_TIMED = {
    "qwen2_serve": (8, 12, 2, 32, 128, None),
    "zamba2_serve": (8, 32, 32, 32, 80, None),
    "long_prefill": (1, 12, 2, 4096, 128, None),
    "long_prefill_window": (1, 12, 2, 4096, 128, 1024),
}
# the reference's bfloat16 logit tolerance (tests/test_models.py:145)
BF16_LOGIT_TOL = 3e-2
# the serve path's arguments; every run serves 16 requests x 32 new tokens
# in slots of 8 at bucket 32
SERVE = {"requests": 16, "max_new": 32, "max_batch": 8, "bucket": 32}
# card vs host at full width and vocab, reduced depth, in float32: float32
# products without TF32 on both sides, so logits differ only by summation
# order (and, in Zamba2, the scan kernel's against its plain version);
# 2e-4 is the reference's own float32 logit tolerance
# (tests/test_models.py:85)
HOST_TOL = 2e-4


def serve_argv(arch):
    return ["--arch", arch, "--requests", str(SERVE["requests"]),
            "--max-batch", str(SERVE["max_batch"]), "--bucket",
            str(SERVE["bucket"]), "--max-new", str(SERVE["max_new"])]


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


def serve_path(kernels, arch, per_slot):
    """``arch`` at full width on the card through serve.main, every
    kernel's count reset just before and read just after; ``per_slot``
    maps a kernel module to the launches each slot must make.  Returns
    the counts, the first inputs each counted kernel was given, and the
    last slot's ``run_slot`` arguments and prefill / decode walls."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config(arch)
    slots, last, first = [], {}, {}
    run_slot = serve.run_slot
    names = {mod: mod.__name__.rsplit(".", 1)[-1] for mod in kernels}
    wrapped = {mod: getattr(mod, names[mod]) for mod in per_slot}

    def recording_slot(*args, **kw):
        out = run_slot(*args, **kw)
        _, logits, tp, td = out
        slots.append((bool(torch.isfinite(logits.float()).all()), tp, td))
        last["args"] = args
        return out

    def recording(mod, fn):
        def call(*args, **kw):
            if mod not in first:
                first[mod] = ([a.clone() for a in args], kw)
            return fn(*args, **kw)
        return call

    serve.run_slot = recording_slot
    for mod, fn in wrapped.items():
        setattr(mod, names[mod], recording(mod, fn))
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        t0 = time.perf_counter()
        rc = serve.main(serve_argv(arch))
        torch.cuda.synchronize()
        counts = {m: m.launches for m in kernels}
    finally:
        serve.run_slot = run_slot
        for mod, fn in wrapped.items():
            setattr(mod, names[mod], fn)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t_prefill = sum(sl[1] for sl in slots)
    t_decode = sum(sl[2] for sl in slots)
    tokens = SERVE["requests"] * SERVE["max_new"]
    log(f"serve {arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}): {len(slots)} slots, wall "
        f"{wall:.2f} s (params init included), prefill {t_prefill:.4f} s, "
        f"decode {t_decode:.4f} s, {tokens / t_decode:.1f} tok/s "
        f"batch-aggregate, peak {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.3f} GB), launches "
        f"{ {names[m]: n for m, n in counts.items()} }; per slot prefill "
        f"{[round(sl[1], 4) for sl in slots]} s, decode "
        f"{[round(sl[2], 4) for sl in slots]} s")
    assert rc == 0, rc
    assert all(sl[0] for sl in slots), "non-finite logits"
    assert len(slots) > 1, "no warm slot to break down"
    for mod, n in per_slot.items():
        assert counts[mod] == len(slots) * n > 0, (names[mod], counts[mod],
                                                   len(slots), n)
    return counts, first, last["args"], slots[-1][1:]


def serve_breakdown(kernels, slot_args, walls, shares, profiled_steps=4):
    """Where the serve path's last (warm) slot spent its time: its prefill
    and decode walls from the serve run, and the device's kernel time, each
    named kernel's part (``shares``: label -> device kernel name) and the
    top kernels from the same slot's prefill and first decode steps, with
    its params, run again under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    cfg, prefill, step, params, prompts, bucket, max_new = slot_args
    t_prefill, t_decode = walls
    batch = len(prompts)
    tokens = serve.pad_batch(cfg, prompts, bucket, "cuda")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    counts = {m: m.launches for m in kernels}
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
    for m, n in counts.items():  # profiling launches are not the main path's
        m.launches = n

    def device_us(prof):
        by_name, n = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + \
                    e.time_range.elapsed_us()
                n += 1
        return by_name, n

    (pre, n_pre), (dec, n_dec) = device_us(prof_prefill), \
        device_us(prof_decode)
    pre_ms, dec_ms = sum(pre.values()) / 1e3, sum(dec.values()) / 1e3
    steps = max_new - 1
    dec_ms *= steps / profiled_steps  # device time of all the slot's steps
    parts = []
    for label, kernel in shares.items():
        ms = sum(v for k, v in pre.items() if kernel in k) / 1e3
        parts.append(f"{label} kernel {ms:.3f} ms "
                     f"({ms / (t_prefill * 1e3):.1%} of the prefill wall, "
                     f"{ms / pre_ms:.1%} of its device time)")
        assert ms > 0, f"the profiler saw no {label} kernel"
    top_pre = sorted(pre.items(), key=lambda kv: -kv[1])[:5]
    top = sorted(dec.items(), key=lambda kv: -kv[1])[:5]
    log(f"serve breakdown {cfg.name}, the last (warm) slot, {batch} x bucket "
        f"{bucket}: prefill wall {t_prefill * 1e3:.3f} ms, device kernel "
        f"time {pre_ms:.3f} ms ({pre_ms / (t_prefill * 1e3):.1%} of the "
        f"wall); " + "; ".join(parts) + "; top prefill kernels: "
        + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top_pre))
    log(f"serve breakdown {cfg.name}: decode wall "
        f"{t_decode * 1e3 / steps:.3f} ms a step over {steps} steps, device "
        f"kernel time {dec_ms / steps:.3f} ms a step "
        f"({dec_ms / (t_decode * 1e3):.1%} busy; {profiled_steps} steps "
        f"profiled, {n_dec / profiled_steps:.0f} device ops (kernels and "
        f"copies) a step, "
        f"{n_pre} in the prefill), top kernels by device time: "
        + "; ".join(f"{k[:60]} {v / 1e3 / profiled_steps:.3f} ms/step"
                    for k, v in top))


def serve_card_vs_host(arch, n_requests, **replace):
    """One set of params, ``arch`` at full width cut by ``replace`` (depth,
    float32), served on the card and on the host from one seed."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.runtime.serving import SlotQueue

    bucket, max_new = SERVE["bucket"], SERVE["max_new"]
    cfg = get_config(arch).replace(**replace)
    prefill, model = make_prefill_step(cfg, cache_len=bucket + max_new)
    step, _ = make_serve_step(cfg)
    host_params = model.init(torch.Generator().manual_seed(0))
    prompts = serve.make_requests(cfg, n_requests, seed=0)
    runs = {}
    for device in (torch.device("cpu"), resolve_device("cuda")):
        params = params_from_reference(host_params, device)
        queue = SlotQueue(buckets=(bucket,), max_batch=SERVE["max_batch"])
        for i, p in enumerate(prompts):
            queue.add(arch, len(p), i)
        gen = np.zeros((n_requests, max_new), np.int32)
        logits = []
        with torch.inference_mode():
            while len(queue):
                idxs = queue.drain(arch, bucket)
                rows, lg, _, _ = serve.run_slot(
                    cfg, prefill, step, params, [prompts[i] for i in idxs],
                    bucket, max_new)
                gen[np.asarray(idxs)] = rows
                logits.append(lg.float().cpu())
        runs[device.type] = (gen, torch.cat(logits))
        del params
    (gen_h, lg_h), (gen_c, lg_c) = runs["cpu"], runs["cuda"]
    same = (gen_h == gen_c).all(axis=1)
    err = check_close(f"serve {arch} logits card vs host", lg_c, lg_h,
                      HOST_TOL)
    log(f"serve {arch} {cfg.num_layers} layers full width {cfg.dtype}, card "
        f"vs host: {int(same.sum())}/{n_requests} requests with identical "
        f"greedy tokens ({max_new} each), last-step logits max|diff| "
        f"{err:.3e} (tol {HOST_TOL})")
    assert same.all(), np.nonzero(~same)[0]
    return err


# -- ssd_scan and the Zamba2 serve path -----------------------------------------
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # tests/test_kernels.py
# dt of the multi-chunk shapes: Zamba2's own dt range, so the per-chunk
# decay sum(dt |A|) is of order one at chunk 256 and the carried state
# matters (dt ~ softplus(N(0,1)) ~ 0.7 would decay it to 0 in a chunk)
DT_RANGE = (0.001, 0.01)
# (B, S, H, P, N, chunk, dt range): the serve path's prefill, a long
# prefill, a ragged S, the smoke config, tests/test_kernels.py:124-127
SSD_SHAPES = [
    (8, 32, 80, 64, 64, 32, None),
    (1, 4096, 80, 64, 64, 256, DT_RANGE),
    (1, 1000, 80, 64, 64, 256, DT_RANGE),
    (2, 32, 16, 32, 16, 16, None),
    (1, 64, 2, 16, 8, 16, None),
    (2, 128, 4, 32, 16, 32, None),
    (1, 32, 1, 8, 4, 32, None),
]
ZAMBA2 = "zamba2_2_7b"
# a full-width Mamba2 layer, card vs host, float32, S 1024 (4 chunks): the
# kernel holds its plain version within 1e-4 in float32 and float32
# products without TF32 differ from the host's by about 1e-6, so the scan's
# tolerance bounds the layer's output, state and conv tail
LAYER_TOL = 1e-4


def ssd_inputs(B, S, H, P, N, dtype, seed, dt_range=None, device="cuda"):
    """x, post-softplus dt (or uniform in ``dt_range``), negative A, B_, C_."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = randn(B, S, H, P).to(dtype)
    if dt_range is None:
        dt = torch.nn.functional.softplus(randn(B, S, H))
    else:
        lo, hi = dt_range
        dt = lo + (hi - lo) * torch.rand((B, S, H), generator=g,
                                         device=device)
    A = -torch.exp(0.5 * randn(H))
    return [x, dt, A, randn(B, S, N), randn(B, S, N)]


def ssd_label(B, S, H, P, N, chunk):
    return f"x ({B},{S},{H},{P}) N {N} chunk {chunk}"


def ssd_check(ssd, args, chunk, label):
    y, state = ssd.ssd_scan(*args, chunk=chunk)
    ry, rstate = ssd.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    tol = SSD_TOL[args[0].dtype]
    err = max(check_close(f"ssd_scan {label} y", y.float(), ry.float(), tol),
              check_close(f"ssd_scan {label} state", state, rstate, tol))
    log(f"ssd_scan {label} {str(args[0].dtype)[6:]}: max|kernel-plain| "
        f"{err:.3e} (tol {tol}) over y and the final state")
    return err


def ssd_carry_check(ssd, ref, args, chunk, label):
    """The kernel against the sequential oracle, and the share of ||y||
    that the carried state gives: y minus each chunk scanned alone from a
    zero state."""
    B, S, H, P = args[0].shape
    y, state = ssd.ssd_scan(*args, chunk=chunk)
    ry, rstate = ref.ssd_scan_ref(*args)
    torch.cuda.synchronize()
    err = max(check_close(f"ssd_scan {label} y vs oracle", y.float(), ry,
                          SSD_TOL[torch.float32]),
              check_close(f"ssd_scan {label} state vs oracle", state, rstate,
                          SSD_TOL[torch.float32]))
    nc = S // chunk
    x, dt, A, Bm, Cm = args
    alone, _ = ssd.ssd_scan_plain(
        x.reshape(B * nc, chunk, H, P), dt.reshape(B * nc, chunk, H), A,
        Bm.reshape(B * nc, chunk, -1), Cm.reshape(B * nc, chunk, -1),
        chunk=chunk)
    share = float((ry - alone.reshape(ry.shape).float()).norm() / ry.norm())
    log(f"ssd_scan {label}: max|kernel-sequential oracle| {err:.3e} (tol "
        f"{SSD_TOL[torch.float32]}); the carried state gives {share:.1%} of "
        f"||y|| ({nc} chunks)")
    assert share > 0.05, f"the carried state barely matters ({share:.2%})"
    return err


def mamba2_layer_card_vs_host(ssd, S=1024, batch=1):
    """One full-width Mamba2 layer of Zamba2-2.7B, float32, card vs host,
    with dt_bias -6 so that dt ~ 0.001-0.01 and the state carries across
    the 4 chunks."""
    from repro_torch.common.types import init_params
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.models import ssm

    cfg = get_config(ZAMBA2).replace(dtype="float32")
    params = init_params(ssm.mamba2_spec(cfg), torch.Generator().manual_seed(1))
    params["dt_bias"].fill_(-6.0)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((batch, S, cfg.d_model), generator=g)
    outs = {}
    launches = ssd.launches
    for device in ("cpu", "cuda"):
        with torch.inference_mode():
            out, cache = ssm.mamba2_apply(params_from_reference(params, device),
                                          cfg, x.to(device))
        outs[device] = (out.cpu(), cache["state"].cpu(), cache["conv"].cpu())
    assert ssd.launches == launches + 1
    ssd.launches = launches  # a check, not the main path
    errs = [check_close(f"mamba2 layer {name} card vs host", c, h, LAYER_TOL)
            for name, c, h in zip(("out", "state", "conv tail"),
                                  outs["cuda"], outs["cpu"])]
    log(f"mamba2 layer d_model {cfg.d_model}, {cfg.ssm_heads} heads of "
        f"{cfg.ssm_head_dim}, N {cfg.ssm_state}, S {S} ({S // cfg.ssm_chunk} "
        f"chunks) f32, card vs host: max|diff| out {errs[0]:.3e}, state "
        f"{errs[1]:.3e}, conv tail {errs[2]:.3e} (tol {LAYER_TOL})")
    return max(errs)


def ssd_work(B, S, H, P, N, chunk, elt):
    """Bytes and flops the scan needs: x, dt, A, B_ and C_ read once, y and
    the final state written once; per chunk of L rows, C B^T over the
    causal half once per batch row (it does not depend on the head), and
    per head the causal half of the decayed product with x, its mask and
    decay (3 ops a pair), the carried state's term (after the first chunk)
    and the state update."""
    nbytes = (2 * B * S * H * P * elt + 4 * B * S * H + 4 * H
              + 2 * 4 * B * S * N + 4 * B * H * P * N)
    flops = 0
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        pairs = L * (L + 1) // 2
        flops += B * 2 * pairs * N
        flops += B * H * (2 * pairs * P + 3 * pairs + 2 * L * P * N)
        if c0:
            flops += B * H * 2 * L * P * N
    return nbytes, flops


def ssd_timing(ssd, B, S, H, P, N, chunk, dt_range, dtype=torch.float32,
               iters=20):
    """Kernel and plain ms at one shape, with the bound: max(flops / the
    float32 peak outside the tensor cores, bytes / HBM rate)."""
    elt = torch.finfo(dtype).bits // 8
    nbytes, flops = ssd_work(B, S, H, P, N, chunk, elt)
    copies = max(1, min(16, -(-128 * 2**20 // nbytes)))
    sets = [ssd_inputs(B, S, H, P, N, dtype, 300 + i, dt_range)
            for i in range(copies)]
    launches = ssd.launches
    ms = time_ms(lambda *a: ssd.ssd_scan(*a, chunk=chunk), sets, iters)
    ssd.launches = launches  # timing launches are not the main path's
    plain_ms = time_ms(lambda *a: ssd.ssd_scan_plain(*a, chunk=chunk), sets,
                       max(3, iters // 4))
    ops_ms = flops / F32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    bound_ms = max(bytes_ms, ops_ms)
    log(f"ssd_scan timing {ssd_label(B, S, H, P, N, chunk)} "
        f"{str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}: {flops} flops, {nbytes} B), "
        f"kernel at {bound_ms / ms:.2%} of bound, {copies} input copies "
        f"rotated")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": [B, S, H, P, N, chunk]}


def ssd_smem_bytes(chunk, P, N, tile=64, warps=8):
    """The kernel's dynamic shared memory per block (smem_floats in
    csrc/ssd_scan.cu): cum, dt, w, warp sums, state, C/B/x/G tiles."""
    return 4 * (3 * chunk + warps + P * (N + 1) + 2 * tile * (N + 1)
                + tile * P + tile * (tile + 1))


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


def fa_visible_pairs(S, causal, window):
    """(query, key) pairs the mask leaves visible: sum over rows i of
    min(i + 1, window) for causal attention with a window."""
    i = np.arange(S, dtype=np.int64)
    hi = i + 1 if causal else np.full(S, S, np.int64)
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo).sum())


def graph_ms(fn, arg_sets, iters):
    """Mean ms per call of ``iters`` calls captured in one CUDA graph and
    replayed: the device's time, without the host's work per call."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def fa_timing(fa, ref, B, H, KV, S, hd, window=None, dtype=torch.bfloat16,
              iters=20):
    """Kernel, plain and SDPA ms for causal attention at one shape, each
    timed as eager calls (host work included) and kernel and SDPA also
    from a CUDA graph, with the bound: max(flops / bf16 tensor peak,
    bytes / HBM rate), where QK^T and PV need 4*B*H*hd flops per visible
    (query, key) pair and q, k and v move in once and o out once."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    elt = torch.finfo(dtype).bits // 8
    nbytes = 2 * (B * H + B * KV) * S * hd * elt
    copies = max(1, min(32, -(-128 * 2**20 // nbytes)))
    sets = [fa_inputs(B, H, KV, S, hd, dtype, 200 + i) for i in range(copies)]
    mask = None if window is None else \
        ref.attention_mask(S, True, window, "cuda")

    def kernel(q, k, v):
        return fa.flash_attention(q, k, v, window=window)

    def library(q, k, v):
        if mask is None:
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)
        return sdpa(q, k, v, attn_mask=mask, enable_gqa=True)

    launches = fa.launches
    ms = time_ms(kernel, sets, iters)
    lib_ms = time_ms(library, sets, iters)
    graph_kernel_ms = graph_ms(kernel, sets, iters)
    graph_lib_ms = graph_ms(library, sets, iters)
    ms_2 = time_ms(kernel, sets, iters)  # in turns: kernel, sdpa, ..., kernel
    fa.launches = launches  # timing launches are not the main path's
    plain_ms = time_ms(
        lambda q, k, v: fa.flash_attention_plain(q, k, v, window=window),
        sets, max(5, iters // 4))
    flops = 4 * B * H * hd * fa_visible_pairs(S, True, window)
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    bound_ms = max(bytes_ms, ops_ms)
    log(f"flash_attention timing {fa_shape_label(B, H, KV, S, hd, True, window)}"
        f" {str(dtype)[6:]}: kernel {ms:.4f} / {ms_2:.4f} ms (eager, first "
        f"and last), {graph_kernel_ms:.4f} ms (graph); sdpa {lib_ms:.4f} ms "
        f"(eager), {graph_lib_ms:.4f} ms (graph); plain {plain_ms:.4f} ms; "
        f"bound {bound_ms:.6f} ms ({bound_by}: {flops} flops, {nbytes} B); "
        f"kernel at {bound_ms / graph_kernel_ms:.2%} of bound (graph), "
        f"{graph_lib_ms / graph_kernel_ms:.2f}x sdpa's speed (graph); "
        f"{copies} input copies rotated")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "graph_ms": graph_kernel_ms, "library_graph_ms": graph_lib_ms,
            "shape": [B, H, KV, S, hd], "window": window}


def prefill_kernel_vs_plain(fa, arch="qwen2_1_5b", num_layers=2):
    """``arch`` at full width cut to ``num_layers``, bf16, one slot of 8 at
    bucket 32 on the card from one set of params: prefill and greedy decode
    through the kernel, then again with ``ops.flash_attention`` (what the
    attention layer calls) replaced by the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    bucket, max_new, batch = SERVE["bucket"], SERVE["max_new"], \
        SERVE["max_batch"]
    cfg = get_config(arch).replace(num_layers=num_layers)
    prefill, model = make_prefill_step(cfg, cache_len=bucket + max_new)
    step, _ = make_serve_step(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = serve.make_requests(cfg, batch, seed=0)
    tokens = serve.pad_batch(cfg, prompts, bucket, "cuda")
    through_kernel = ops.flash_attention

    def through_plain(q, k, v, *, causal=True, window=None):
        return fa.flash_attention_plain(q, k, v, causal=causal, window=window)

    runs, launches = {}, fa.launches
    for name, fn in (("kernel", through_kernel), ("plain", through_plain)):
        ops.flash_attention = fn
        try:
            with torch.inference_mode():
                logits, _ = prefill(params, tokens)
                gen, _, _, _ = serve.run_slot(cfg, prefill, step, params,
                                              prompts, bucket, max_new)
        finally:
            ops.flash_attention = through_kernel
        runs[name] = (logits[:, -1].float(), gen)
    made = fa.launches - launches
    fa.launches = launches  # a check, not the main path
    assert made == 2 * num_layers, made  # two prefills through the kernel
    (lg_k, gen_k), (lg_p, gen_p) = runs["kernel"], runs["plain"]
    err = check_close(f"{arch} bf16 prefill logits kernel vs plain", lg_k,
                      lg_p, BF16_LOGIT_TOL)
    same = float((gen_k == gen_p).mean())
    log(f"{arch} {num_layers} layers full width bf16, one slot of {batch} at "
        f"bucket {bucket}, through the kernel vs the plain version: "
        f"last-position logits max|diff| {err:.3e} (tol {BF16_LOGIT_TOL}); "
        f"{same:.1%} of greedy tokens ({max_new} a request) agree, "
        f"{int((gen_k == gen_p).all(axis=1).sum())}/{batch} requests "
        "identical")
    return err, same


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
                        "Compiling entry" in line or "warning" in line:
                    log(f"  ptxas: {line.strip()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
        from repro_torch.core import losses
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import kd_loss as kd
        from repro_torch.kernels import ref
        from repro_torch.kernels import ssd_scan as ssd
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = gpu_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    kernels = (kd, fa, ssd)

    # 1. build every kernel, in parallel
    build_all(kernels)
    log(f"ssd_scan dynamic shared memory per block: "
        f"{ssd_smem_bytes(256, 64, 64)} B at chunk 256, P = N = 64; "
        f"{ssd_smem_bytes(32, 64, 64)} B at the serve path's chunk 32")
    log("flash_attention dynamic shared memory per block: " + "; ".join(
        f"head_dim {hd} bf16 {fa.smem_bytes(hd, torch.bfloat16)} B, f32 "
        f"{fa.smem_bytes(hd, torch.float32)} B" for hd in fa.HEAD_DIMS))

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

    # 7. the Qwen2 serve path at full width, then the kernel at its prefill
    # shape
    counts, first, slot_args, walls = serve_path(
        kernels, "qwen2_1_5b", {fa: get_config("qwen2_1_5b").num_layers})
    fa_launches = counts[fa]
    (q, k, v), kw = first[fa]
    B, H, S, hd = q.shape
    KV = k.shape[1]
    label = "serve-path " + fa_shape_label(B, H, KV, S, hd,
                                           kw["causal"], kw["window"])
    fa_errs.append(fa_check(fa, q, k, v, kw["causal"], kw["window"],
                            label + " (its own q/k/v)"))
    rq, rk, rv = fa_inputs(B, H, KV, S, hd, q.dtype, 7)
    fa_errs.append(fa_check(fa, rq, rk, rv, kw["causal"], kw["window"],
                            label))
    del q, k, v, rq, rk, rv, first

    # 8. where the warm Qwen2 slot's time went, under the profiler
    serve_breakdown(kernels, slot_args, walls, {"flash": "flash_fwd"})
    del slot_args

    # 9. one set of params on the card and on the host, 2 layers
    serve_card_vs_host("qwen2_1_5b", 16, num_layers=2, dtype="float32")

    # 10. flash_attention timings, bf16 causal, the four shapes in turns
    assert (B, H, KV, S, hd) == FA_TIMED["qwen2_serve"][:5]
    fa_times = {name: fa_timing(fa, ref, *shape[:5], window=shape[5],
                                iters=50 if shape[3] <= 64 else 10)
                for name, shape in FA_TIMED.items()}
    fa_main = fa_times["qwen2_serve"]

    # 11. ssd_scan vs plain at the listed shapes, f32 and bf16; the long
    # prefill also against the sequential oracle, with the carry's share
    ssd_errs = []
    for B, S, H, P, N, chunk, dt_range in SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(B, S, H, P, N, dtype, S + P, dt_range)
            ssd_errs.append(ssd_check(ssd, args, chunk,
                                      ssd_label(B, S, H, P, N, chunk)))
            if S == 4096 and dtype == torch.float32:
                ssd_errs.append(ssd_carry_check(
                    ssd, ref, args, chunk, ssd_label(B, S, H, P, N, chunk)))
            del args

    # 12. the Zamba2 serve path at full width: ssd_scan in every Mamba2
    # layer's prefill, flash in every application of the shared block
    zcfg = get_config(ZAMBA2)
    counts, first, slot_args, walls = serve_path(
        kernels, ZAMBA2, {ssd: zcfg.num_layers,
                          fa: zcfg.num_layers // zcfg.attn_every})
    ssd_launches, zfa_launches = counts[ssd], counts[fa]
    args, kw = first[ssd]
    B, S, H, P = args[0].shape
    label = "serve-path " + ssd_label(B, S, H, P, args[3].shape[-1],
                                      kw["chunk"])
    ssd_errs.append(ssd_check(ssd, args, kw["chunk"],
                              label + " (its own x/dt/A/B/C)"))
    (q, k, v), fkw = first[fa]
    fa_errs.append(fa_check(fa, q, k, v, fkw["causal"], fkw["window"],
                            "zamba2 serve-path " + fa_shape_label(
                                *q.shape[:2], k.shape[1], *q.shape[2:],
                                fkw["causal"], fkw["window"])
                            + " (its own q/k/v)"))
    del args, q, k, v, first

    # 13. where the warm Zamba2 slot's time went
    serve_breakdown(kernels, slot_args, walls,
                    {"ssd_scan": "ssd_fwd", "flash": "flash_fwd"})
    del slot_args

    # 14. one full-width Mamba2 layer, card vs host, 4 chunks
    layer_err = mamba2_layer_card_vs_host(ssd)

    # 15. one set of params on the card and on the host, 12 layers (2
    # super-blocks, so two KV caches of the shared block), one slot of 8
    serve_card_vs_host(ZAMBA2, 8, num_layers=12, dtype="float32")

    # 16. ssd_scan timings, f32, at the serve shape and a long prefill
    ssd_main = ssd_timing(ssd, 8, 32, 80, 64, 64, 32, None, iters=50)
    ssd_long = ssd_timing(ssd, 1, 4096, 80, 64, 64, 256, DT_RANGE, iters=10)
    log("ssd_scan library_ms: no single PyTorch call computes this scan, so "
        "there is no library yardstick")
    # 17. a bf16 Qwen2 prefill through the kernel and through its plain
    # version
    e2e_err, e2e_same = prefill_kernel_vs_plain(fa)
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
        "design": "wgmma+tma bf16; CUDA-core f32",
        "graph_ms": fa_main["graph_ms"],
        "library_graph_ms": fa_main["library_graph_ms"],
        "zamba2_serve": fa_times["zamba2_serve"],
        "long_prefill": fa_times["long_prefill"],
        "long_prefill_window": fa_times["long_prefill_window"],
        "zamba2_launches": zfa_launches,
        "bf16_prefill_logits_kernel_vs_plain": e2e_err,
        "bf16_greedy_tokens_agree": e2e_same,
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:89",
        "launches": ssd_launches,
        "max_abs_err": max(ssd_errs),
        "ms": ssd_main["ms"],
        "plain_ms": ssd_main["plain_ms"],
        "bound_ms": ssd_main["bound_ms"],
        "bound_by": ssd_main["bound_by"],
        "library_ms": None,
        "shape": ssd_main["shape"],
        "long_prefill": ssd_long,
        "mamba2_layer_card_vs_host_err": layer_err,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
