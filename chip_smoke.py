#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`horovod_tpu_torch`): the quickest
proof that the port builds, is right and serves on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the result line):

1. toolchain — the card's name and power limit (``nvidia-smi``), torch,
   CUDA, ``nvcc`` versions and whether Triton imports;
2. build — every CUDA kernel of the serving path from
   ``horovod_tpu_torch/ops/csrc`` with ``nvcc`` for ``sm_90a`` (one ``nvcc``
   per source, all started together);
3. kernels against their plain PyTorch versions on the card, in every mask
   case, with the kernel's, the plain version's and the library call's
   times at the serving shapes beside the card's bound;
4. the main path — a `TransformerLM` at the bench LM's full width (vocab
   8192, d_model 512, 8 heads, 8 layers, bf16 compute, seeded weights) is
   exported as a streaming bundle (batch 8, prompt_len 128, 64 new tokens,
   chunk 16, greedy) and served by ``make_server`` → continuous-batching
   engine; 12 concurrent ragged requests (some streaming) must each get 64
   tokens equal to the bundle run on that prompt alone, and the flash
   launch count must equal n_layers × prefill dispatches;
5. the main path against the plain path — one f32 prefill at 8 × 128 on
   the card (kernel) and on the CPU (plain version), logits compared;
6. the ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result. Everything it writes goes under ``build/chip_smoke/``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM data sheet (dense, without sparsity) — the bound's denominators.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Tolerances, kernel against its plain version on the same inputs. bf16:
# the two compute P·V in different orders and round P and O to 8 bits, so
# O may differ by about two bf16 ulps of its value; lse is f32 math on the
# same bf16 inputs. f32: summation order only.
TOL = {
    "bfloat16": {"o_atol": 2e-2, "o_rtol": 1e-2, "lse": 1e-3},
    "float32": {"o_atol": 1e-4, "o_rtol": 0.0, "lse": 1e-4},
}
# Phase 5: f32 logits of the whole 8-layer model, kernel vs plain path;
# matmul summation orders differ between cuBLAS and the CPU.
LOGITS_ATOL = 2e-3

MODEL = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=8,
             dropout=0.0)
BATCH, PROMPT_LEN, NEW_TOKENS, CHUNK = 8, 128, 64, 16
N_REQUESTS = 12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


# -- phase 1 -----------------------------------------------------------------

def toolchain(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from horovod_tpu_torch.ops import _build

    nvcc = _build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60)
    check(ver.returncode == 0, f"{nvcc} --version failed: {ver.stderr}")
    try:
        import triton  # noqa: F401

        triton_ver = triton.__version__
    except ImportError:
        triton_ver = None
    info = {
        "card": card, "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": ver.stdout.strip().splitlines()[-1], "triton": triton_ver,
        "device_count": torch.cuda.device_count(),
    }
    log("toolchain", json.dumps(info))
    return card


# -- phase 2 -----------------------------------------------------------------

def build_kernels():
    """One nvcc per kernel source, all started together."""
    from horovod_tpu_torch.ops import _build

    names = ["flash_fwd"]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for name, fut in [(n, pool.submit(_build.library, n)) for n in names]:
            fut.result()
            log(f"build {name}: {_build.build_seconds[name]:.2f} s")
    log(f"build all: {time.perf_counter() - t0:.2f} s")


# -- phase 3 -----------------------------------------------------------------

def device_ms(torch, fn, iters=50):
    """Device time of one ``fn()`` call: ``iters`` calls captured in a
    CUDA graph, replayed between CUDA events, so host launch overhead is
    not what is measured. Inputs stay warm in L2, as the model's prefill
    finds them right after its qkv projection."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def attention_bound_ms(b, tq, tk, h, hkv, d, dtype_name, *, causal,
                       q_offset=None):
    """Least time for the same work on this card: the larger of (each input
    read once + each output written once) over HBM bandwidth and the score
    and P·V products the masks keep over the peak rate of the dtype."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = (b * tq * h * d * 2 + b * tk * hkv * d * 2) * item \
        + b * tq * h * 4
    if causal:
        off = tk - tq if q_offset is None else q_offset
        visible = sum(max(0, min(tk, r + off + 1)) for r in range(tq))
    else:
        visible = tq * tk
    flops = 4.0 * b * h * d * visible
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def kernel_cases(torch):
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    # (name, B, Tq, Tk, H, Hkv, D, dtype, kwargs, segments)
    cases = [
        ("serving_prefill", 8, 128, 128, 8, 8, 64, bf16, {}, False),
        ("long_prompt", 1, 2048, 2048, 8, 8, 64, bf16, {}, False),
        ("window256_sinks4", 2, 1024, 1024, 8, 8, 64, bf16,
         {"window": 256, "sinks": 4}, False),
        ("packed_segments", 2, 512, 512, 8, 8, 64, bf16, {}, True),
        ("cross_length_q_offset", 2, 200, 700, 8, 8, 64, bf16,
         {"q_offset": 300}, False),
        ("fully_masked_rows", 2, 256, 256, 8, 8, 64, bf16,
         {"q_offset": -40}, False),
        ("gqa_noncausal", 2, 192, 320, 8, 2, 128, bf16,
         {"causal": False}, False),
        ("f32_window", 2, 384, 384, 8, 8, 64, f32, {"window": 100}, False),
        ("head_dim_256", 1, 100, 300, 4, 2, 256, bf16,
         {"window": 64, "sinks": 3}, False),
        ("head_dim_40_f32", 2, 77, 77, 4, 4, 40, f32, {}, False),
    ]
    results = {}
    worst = 0.0
    with torch.inference_mode():
        for name, b, tq, tk, h, hkv, d, dt, kw, segs in cases:
            kw = {"causal": True, **kw}
            q = rand(b, tq, h, d, dtype=dt)
            k = rand(b, tk, hkv, d, dtype=dt)
            v = rand(b, tk, hkv, d, dtype=dt)
            if segs:
                # Packed documents with random boundaries; q rows of one
                # extra id that no key carries are fully masked.
                cuts = torch.sort(torch.randint(
                    1, tq, (b, 6), generator=gen, device="cuda")).values
                ids = (torch.arange(tq, device="cuda")[None, :, None]
                       >= cuts[:, None, :]).sum(-1).to(torch.int32)
                kw["q_segment_ids"] = torch.where(
                    torch.arange(tq, device="cuda") >= tq - 16, 99, ids)
                kw["kv_segment_ids"] = ids
            out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
            torch.cuda.synchronize()
            ref_o, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
            tol = TOL[str(dt).removeprefix("torch.")]
            o_err = (out.float() - ref_o.float()).abs()
            o_ok = bool((o_err <= tol["o_atol"]
                         + tol["o_rtol"] * ref_o.float().abs()).all())
            lse_err = float((lse - ref_lse).abs().max())
            check(torch.isfinite(out.float()).all(), f"{name}: non-finite O")
            empty = ref_lse <= -1e29
            if bool(empty.any()):
                check(bool((out.float()[empty] == 0).all()),
                    f"{name}: a fully masked row has non-zero O")
                check(bool((lse[empty] == -1e30).all()),
                      f"{name}: a fully masked row has lse != -1e30")
            check(o_ok, f"{name}: O differs from the plain version "
                  f"(max abs {float(o_err.max()):.3g})")
            check(lse_err <= tol["lse"],
                  f"{name}: lse differs from the plain version ({lse_err:.3g})")
            worst = max(worst, float(o_err.max()))
            results[name] = {"o_max_abs_err": float(o_err.max()),
                             "lse_max_abs_err": lse_err,
                             "empty_rows": int(empty.sum())}
            log(f"kernel flash_fwd {name}: O err {float(o_err.max()):.3g}, "
                f"lse err {lse_err:.3g}, fully masked rows "
                f"{int(empty.sum())} — ok")

        timings = {}
        for name, b, t, h, d in (("serving_prefill", 8, 128, 8, 64),
                                 ("long_prompt", 1, 2048, 8, 64)):
            q, k, v = (rand(b, t, h, d, dtype=bf16) for _ in range(3))
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            ms = device_ms(torch, lambda: fa.flash_attention_with_lse(q, k, v))
            plain = device_ms(
                torch, lambda: fa.flash_attention_reference(q, k, v), 10)
            lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True))
            bound, by = attention_bound_ms(b, t, t, h, h, d, "bfloat16",
                                           causal=True)
            timings[name] = {"shape": [b, t, h, d], "ms": ms,
                             "plain_ms": plain, "library_ms": lib,
                             "bound_ms": bound, "bound_by": by}
            log(f"time flash_fwd {name} B{b} T{t} H{h} D{d} causal bf16: "
                f"kernel_ms {ms:.5f} plain_ms {plain:.5f} library_ms "
                f"(sdpa) {lib:.5f} bound_ms {bound:.5f} ({by})")
    return results, timings, worst


# -- phase 4 -----------------------------------------------------------------

def _post(url, payload, timeout=300):
    """POST JSON; returns (lines, t_first_line, t_done) on the host clock."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        check(resp.status == 200, f"HTTP {resp.status}")
        first = None
        lines = []
        for raw in resp:
            if first is None:
                first = time.perf_counter()
            lines.append(json.loads(raw))
        return lines, first, time.perf_counter()


def main_path(torch):
    from horovod_tpu_torch.launch.serve import make_server
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import export_generate

    import numpy as np

    model = TransformerLM(**MODEL, compute_dtype=torch.bfloat16,
                          device=DEVICE, seed=0)
    bundle_dir = export_generate(
        os.path.join(WORK, "bundles"), model, batch_size=BATCH,
        prompt_len=PROMPT_LEN, max_new_tokens=NEW_TOKENS,
        streaming_chunk=CHUNK, timestamp="smoke",
    )
    del model
    server = make_server(bundle_dir, port=0, device=DEVICE)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    engine = server.app.engine
    bundle = server.app.bundle
    try:
        health = json.loads(urllib.request.urlopen(f"{url}/healthz",
                                                   timeout=60).read())
        check(health["status"] == "ok", f"healthz: {health}")
        # Warm-up request (first cuBLAS/allocator use), outside the count.
        _post(f"{url}/v1/generate", {"prompt": [[1, 2, 3]]})

        rng = np.random.RandomState(0)
        lengths = [1, PROMPT_LEN] + list(rng.randint(1, PROMPT_LEN + 1,
                                                     N_REQUESTS - 2))
        prompts = [rng.randint(0, MODEL["vocab_size"], n).tolist()
                   for n in lengths]
        stream = [i % 2 == 0 for i in range(N_REQUESTS)]
        prefills0 = engine.stats()["prefill_calls_total"]
        calls0 = engine.stats()["device_calls_total"]
        fa.launches = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(N_REQUESTS) as pool:
            futs = [pool.submit(_post, f"{url}/v1/generate",
                                {"prompt": [p], "stream": s})
                    for p, s in zip(prompts, stream)]
            replies = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        launches = fa.launches
        stats = engine.stats()
        prefills = stats["prefill_calls_total"] - prefills0
        device_calls = stats["device_calls_total"] - calls0
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)

    tokens, ttft = [], []
    for (lines, first, done), s in zip(replies, stream):
        check(lines and lines[-1].get("done") if s else len(lines) == 1,
              f"malformed reply {lines[-1:]}")
        toks = lines[-1]["tokens"][0]
        if s:
            pieces = [x for ln in lines[:-1] for x in ln["tokens"][0]]
            check(pieces == toks, "streamed chunks differ from the done line")
            ttft.append(first - t0)
        tokens.append(toks)
    for i, toks in enumerate(tokens):
        check(len(toks) == NEW_TOKENS,
              f"request {i} got {len(toks)} tokens, want {NEW_TOKENS}")
        check(all(0 <= x < MODEL["vocab_size"] for x in toks),
              f"request {i}: token ids out of range")
    # The ragged contract: each request's tokens equal the bundle run on
    # that prompt alone (same device, same batch shape, row 0).
    for i, p in enumerate(prompts):
        alone = bundle.generate_batch([p])[0]
        check(alone == tokens[i],
              f"request {i} (len {len(p)}) differs from its solo run")
    # Informational: batch-1 generate at the prompt's own length runs other
    # matmul shapes, so bf16 rounding may flip a near-tie. Where it differs,
    # record the top-1/top-2 logit margin at the first differing step.
    from horovod_tpu_torch.models.decoding import generate

    same_b1, margins = 0, []
    for i, p in enumerate(prompts):
        b1 = generate(bundle.model, torch.tensor([p]), NEW_TOKENS,
                      include_prompt=False)[0].tolist()
        if b1 == tokens[i]:
            same_b1 += 1
            continue
        j = next(n for n, (x, y) in enumerate(zip(b1, tokens[i])) if x != y)
        with torch.inference_mode():
            logits = bundle.model(torch.tensor([p + b1[:j]], device=DEVICE))
        top2 = logits[0, -1].float().topk(2).values
        margins.append({"request": i, "step": j,
                        "margin": float(top2[0] - top2[1])})
    check(launches == MODEL["n_layers"] * prefills,
          f"flash launches {launches} != n_layers × prefills "
          f"({MODEL['n_layers']} × {prefills})")
    check(launches > 0, "the main path never launched the flash kernel")
    ttft.sort()
    serve = {
        "requests": N_REQUESTS, "prompt_lengths": [len(p) for p in prompts],
        "wall_s": wall,
        "ttft_p50_s": ttft[len(ttft) // 2],
        "ttft_p95_s": ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))],
        "decode_tokens_per_s": N_REQUESTS * NEW_TOKENS / wall,
        "device_calls_total": device_calls, "prefill_dispatches": prefills,
        "flash_launches": launches,
        "equal_to_batch1_generate": f"{same_b1}/{N_REQUESTS}",
        "batch1_first_difference": margins,
    }
    log("serve", json.dumps(serve))
    log("breakdown", json.dumps(breakdown(torch, bundle)))
    return launches


def breakdown(torch, bundle):
    """Where a serving tick's time goes at the full batch (8 × 128): host
    wall time of the prefill forward alone, of ``start`` (prefill + first
    chunk) and of ``cont`` (one chunk), each with the device's busy time
    and share and its top kernels from `torch.profiler`. Measured after
    the main path's counts were read; not a check."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.models.decoding import make_rng

    vocab = MODEL["vocab_size"]
    prompts = [[(7 * i + 3 * j) % vocab for j in range(PROMPT_LEN)]
               for i in range(BATCH)]
    padded, lengths = bundle._pad(prompts)
    prompt_t = torch.as_tensor(padded, device=DEVICE)
    state = {}

    def prefill():
        with torch.inference_mode():
            bundle.model.decode(prompt_t,
                                max_decode_len=PROMPT_LEN + NEW_TOKENS)

    def start():
        state["s"] = bundle._start(padded, make_rng(0, DEVICE), lengths)[1]

    def cont():
        bundle._cont(state["s"])

    out = {}
    for name, fn in (("prefill", prefill), ("start", start), ("cont", cont)):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
        busy_ms = sum(by_name.values())
        out[name] = {
            "wall_ms": wall_ms,
            "kernel_launches": len(kernels),
            "device_busy_ms": busy_ms if kernels else "not measured",
            "device_busy_share": busy_ms / wall_ms if kernels
            else "not measured",
            "top_kernels_ms": [
                [n[:70], ms] for n, ms in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            ],
        }
    return out


# -- phase 5 -----------------------------------------------------------------

def main_vs_plain(torch):
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, MODEL["vocab_size"], (BATCH, PROMPT_LEN),
                           generator=gen)
    gpu = TransformerLM(**MODEL, compute_dtype=torch.float32, device=DEVICE,
                        seed=0)
    cpu = TransformerLM(**MODEL, compute_dtype=torch.float32, device="cpu",
                        seed=0)
    with torch.inference_mode():
        before = fa.launches
        logits_gpu, _ = gpu.decode(prompt.to(DEVICE),
                                   max_decode_len=PROMPT_LEN + NEW_TOKENS)
        check(fa.launches - before == MODEL["n_layers"],
              "the f32 prefill did not run the flash kernel per layer")
        logits_gpu = logits_gpu.cpu()
        logits_cpu, _ = cpu.decode(prompt,
                                   max_decode_len=PROMPT_LEN + NEW_TOKENS)
    check(torch.isfinite(logits_gpu).all(), "non-finite logits on the card")
    check(logits_gpu.shape == (BATCH, PROMPT_LEN, MODEL["vocab_size"]),
          f"logits shape {tuple(logits_gpu.shape)}")
    err = float((logits_gpu - logits_cpu).abs().max())
    log(f"prefill f32 card (kernel) vs cpu (plain): max abs logits err "
        f"{err:.3g} (tolerance {LOGITS_ATOL})")
    check(err <= LOGITS_ATOL, "card prefill logits differ from the plain path")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "horovod_tpu_torch")):
        print("chip_smoke: the horovod_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t_start = time.perf_counter()
    try:
        card = toolchain(torch)
        build_kernels()
        errs, timings, worst = kernel_cases(torch)
        launches = main_path(torch)
        main_vs_plain(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    t = timings["serving_prefill"]
    kernels = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "horovod_tpu/ops/flash_attention.py:149",
        "launches": launches,
        "max_abs_err": errs["serving_prefill"]["o_max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": "B8 T128 H8 D64 causal bf16",
        "long_prompt": timings["long_prompt"],
        "max_abs_err_all_cases": worst,
        "card": card,
    }]}
    log(f"smoke seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
