"""The yardstick of the per-layer device metrics: the card's peaks, the
operations and bytes of each of the port's kernels at the shapes an
executor launches them with, and the model operations of a serving step.

Peaks: NVIDIA's data sheet of the H100 SXM, dense, at its 700 W limit:
989 TFLOP/s in bf16, 3.35 TB/s of HBM. A kernel's bound is the larger of its
operations over the peak rate and its bytes over the HBM rate, each input
byte read once and each output byte written once (the rules of the port's
own card checks, copied here so that a change to the program cannot move
the yardstick).

Shapes: every execution's prefill is one (1, T) prompt; a decode step of the
dense family reads a cache of T slots (the prompt's), one of the SSM family
carries a fixed state.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM = 3.35e12

# the port's kernels in a profiler trace: (metric suffix, launch names,
# names of further passes of the same call)
KERNELS = {
    "K4": (("fa_tc_kernel", "fa_f32_kernel"), ()),
    "K5": (("dec_tc_kernel", "dec_f32_kernel"), ("dec_combine",)),
    "K6": (("ssd_tc_kernel", "ssd_chunk_kernel"), ("ssd_carry_kernel",)),
}


def kind_of(name: str) -> tuple[str, bool] | None:
    """(kernel, whether this is the launch that counts one call)."""
    for k, (main, more) in KERNELS.items():
        if any(m in name for m in main):
            return k, True
        if any(m in name for m in more):
            return k, False
    return None


def live_pairs(S: int) -> int:
    return S * (S + 1) // 2


def k4(p: dict, T: int) -> tuple[float, float]:
    """Causal prefill attention over a (1, T) prompt, bf16: (ops, bytes)."""
    H, Hkv, D = p["n_heads"], p["n_kv_heads"], p["head_dim"]
    ops = 4.0 * H * live_pairs(T) * D
    nbytes = 2.0 * T * D * (2 * H + 2 * Hkv)
    return ops, nbytes


def k5(p: dict, T: int) -> tuple[float, float]:
    """One decode step's attention over T cache slots, bf16."""
    H, Hkv, D = p["n_heads"], p["n_kv_heads"], p["head_dim"]
    ops = 4.0 * H * T * D
    nbytes = 2.0 * (2 * T * Hkv * D + 2 * H * D)
    return ops, nbytes


def k6(p: dict, T: int) -> tuple[float, float]:
    """The SSD scan of a (1, T) prompt in one layer, bf16 inputs: operations
    counted at the bf16 rate, a product with a float32 operand three times
    (its split into three bf16 terms)."""
    di = p["ssm_expand"] * p["d_model"]
    hd, ds = p["ssm_head_dim"], p["ssm_state"]
    H = di // hd
    Q = min(p["ssm_chunk"], T)
    score = prod = 0.0
    for r0 in range(0, T, Q):
        qc = min(Q, T - r0)
        tri = qc * (qc + 1) / 2
        score += 2 * tri * ds
        prod += H * (2 * tri * hd + 2 * qc * hd * ds)
        if r0:
            prod += H * 2 * qc * hd * ds
    x = T * H * hd
    nbytes = 2.0 * (2 * x + 2 * T * ds) + 4.0 * (T * H + H + H * hd * ds)
    return score + 3 * prod, nbytes


BOUNDS = {"K4": k4, "K5": k5, "K6": k6}


def bound_s(kernel: str, p: dict, T: int) -> float:
    ops, nbytes = BOUNDS[kernel](p, T)
    return max(ops / PEAK_BF16, nbytes / HBM)


def roofline_pct(ctx: dict, kernel: str) -> float | None:
    """The kernel's share of its roofline over the traced stretch: the
    bound of every call it made there over the device time of all its
    passes. None when the trace shows none of its kernels."""
    calls, secs = 0, 0.0
    for name, s in ctx["kernel_s"].items():
        k = kind_of(name)
        if k is None or k[0] != kernel:
            continue
        secs += s
        if k[1]:
            calls += ctx["kernel_n"][name]
    if not calls or secs <= 0.0:
        return None
    return 100.0 * calls * bound_s(kernel, ctx["cfg"], ctx["prompt_len"]) \
        / secs


def step_flops(p: dict, T: int, family: str) -> tuple[float, float]:
    """Model operations of (one prefill of T tokens, one decode step), the
    mixture's active experts only; the prefill's logits are of its last
    token alone, as the program computes them."""
    d, V = p["d_model"], p["vocab"]
    L = p["n_layers"]
    unembed = 2.0 * d * V
    if family == "ssm":
        di = p["ssm_expand"] * p["d_model"]
        hd, ds = p["ssm_head_dim"], p["ssm_state"]
        nh = di // hd
        proj = 2.0 * d * (2 * di + 2 * ds + nh) + 2.0 * di * d
        conv = 2.0 * p["conv_width"] * (di + 2 * ds)
        scan = 6.0 * nh * hd * ds      # decay, input and readout per token
        tok = L * (proj + conv + scan)
        return T * tok + unembed, tok + unembed
    H, Hkv, D = p["n_heads"], p["n_kv_heads"], p["head_dim"]
    attn = 2.0 * d * D * (2 * H + 2 * Hkv)
    if p.get("n_experts"):
        mlp = 2.0 * p["top_k"] * 3 * d * p["d_ff_expert"] \
            + 2.0 * d * p["n_experts"]
    else:
        mlp = 2.0 * 3 * d * p["d_ff"]
    tok = L * (attn + mlp)
    pre_attn = L * 4.0 * H * D * live_pairs(T)
    dec_attn = L * 4.0 * H * D * T
    return T * tok + pre_attn + unembed, tok + dec_attn + unembed
