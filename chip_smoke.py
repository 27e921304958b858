#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this checkout's ``src/repro_torch``; it
exits non-zero without printing a result when any of them is missing.
Phases, each of which must pass:

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   every kernel of the path, timed;
2. each kernel against its plain PyTorch version on the card, at the main
   path's largest shape and at large vocabularies, f32 and bf16, plus the
   gradient of the fused loss against plain autograd;
3. the main path: the model-exchange cycle at the ``exchange_scale``
   configuration (10,000 LR/MLP parties) on the card, with every kernel's
   launch count reset just before and read just after; then each kernel
   against its plain version at every shape that run gave it;
4. a small seeded exchange run on the card and on the host from one
   state: identical event logs and cycle counts, losses within 1e-5;
5. kernel, plain-version and bound times at the main path's shape and at
   a large vocabulary.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
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


def main_path(kd, cycles):
    """10,000 parties x ``cycles`` on the card; returns launches, shapes."""
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
        kd.launches = 0
        t0 = time.perf_counter()
        report, _ = exchange(cohorts, ex, ey, cycles, edges=32,
                             device="cuda", on_cycle=on_cycle)
        torch.cuda.synchronize()
        launches = kd.launches
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
        f"kd_loss launches {launches}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from repro_torch.core import losses
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

    # 1. build
    t0 = time.perf_counter()
    so = kd.build()
    log(f"nvcc build kd_loss: {time.perf_counter() - t0:.2f} s -> "
        f"{so.relative_to(ROOT)}")
    log_path = so.with_suffix(".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    # 2. kernel vs plain at the listed shapes
    errs = [kd_check(kd, 4096 * 32, 8, torch.float32, 1)]
    for dtype in (torch.float32, torch.bfloat16):
        for n in (200, 256):
            errs.append(kd_check(kd, n, QWEN2_VOCAB, dtype, 2 + n))
    errs.append(kd_check(kd, 131, 1000, torch.float32, 5))  # ragged N and V
    errs.append(kd_self_check(kd))
    errs.append(grad_check(losses, 4, 32, 8, 6))
    errs.append(grad_check(losses, 3, 32, 1000, 7))

    # 3. the main path, then the kernel at every shape it was given
    cycles = 3
    launches, shapes = main_path(kd, cycles)
    for (n, v), dtype in shapes:
        errs.append(kd_check(kd, n, v, dtype, 8 + n))
    log(f"main-path kd_loss shapes: {[s for s, _ in shapes]}")

    # 4. the same state on the card and on the host
    cuda_vs_cpu()

    # 5. timings
    main_n = max(n for (n, _), _ in shapes)
    ms, plain_ms, bound_ms, bound_by = kd_timing(kd, main_n, 8,
                                                 torch.float32)
    kd_timing(kd, 256, QWEN2_VOCAB, torch.float32, iters=20)
    kd_timing(kd, 256, QWEN2_VOCAB, torch.bfloat16, iters=20)
    log("library_ms: no single PyTorch call computes this fused loss, so "
        "there is no library yardstick")
    log(f"kd_loss launches per cycle on the main path: {launches / cycles}")
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
