#!/usr/bin/env python3
"""Where a bf16 verify and the greedy decode part: row and key invariance on one card.

  python3 tools/bf16_invariance.py        # needs one NVIDIA GPU

The tree engine's contract is that its output is the target's greedy
decode.  The verify computes a position's logits among n rows (the tree's
nodes), the greedy decode alone (a decode step, M = 1), and the prefill
among the prompt's rows; a tree node's ancestors sit at rows of the tree's
order, the decode's at consecutive rows.  In float32 the different orders
of summation this allows never moved a token; in bf16 the logits are
rounded to 8 bits, exact ties of the top two are common, and an ulp moved
anywhere upstream breaks a tie one way in the verify and the other in the
decode.  This script measures, on the card, in bf16:

1. products: row 0 of ``x[:M] @ w`` against ``x[:1] @ w`` for M = 2, 4,
   8, 16, at every product of the llama3-8b and llama3-1b layers, their
   lm_heads, and llama3-70b's tp-3 and tp-4 rank shapes, by the port's
   ``stream_matmul`` kernel (the serving forward's product) and by
   torch.matmul (cuBLAS, which the forward called before it), each timed
   at M 1, 8 and 16 (CUDA events, the median of 21 calls after an L2
   flush); the port's ``fused_swiglu`` kernel the same way;
2. attention: ``tree_attention`` with a query's last attended key moved one
   row on (the row between masked) against the key at its own row, over
   random trials at the 8B's and the 70B tp-3 rank's heads (the kernel
   sums a query's keys by rank, so none may differ);
3. the engine: llama3-8b + llama3-1b at full depth in bf16 (``build_engine``'s
   draws, lm_head x4, rounded to bf16), the serve CLI's first two prompts,
   lockstep, max_new 48: every position's two norms, q/k/v, attention,
   output projection, swiglu and MLP output of every layer, the final norm
   and the logits, in the
   verify (the node on the greedy path) against the greedy decode's (its
   prefill for the prompt's last row, which the first verify recomputes);
   it prints the first position and op where they differ, whose inputs
   were equal, and whether the speculative output left the greedy decode
   (where, and the decode's top-2 logit gap there).

4. the families: one layer of each
   family that keeps its own products, at full width in bf16 (seed 0,
   lm_head x4) — deepseek-moe-16b (its dense layer 0 and a moe layer, 64
   experts top 6, drop-free), mixtral-8x22b (a moe layer), minicpm3-4b (an
   MLA layer), zamba2-2.7b (a mamba2 layer) and rwkv6-7b (a time-mix and
   channel-mix layer): a prompt of 16, its greedy decode of 8 tokens step
   by step, and the same 8 tokens in one forward from the prefilled cache
   (a tree verify along a chain for the attention families, a chain
   forward for the recurrent ones); every product (``project``,
   ``stream_bmm``), norm, fused SwiGLU, latent attention, the MoE's routing
   weights (its softmax and top-k sum), its experts' results per row and
   their sum over k, the recurrent scans and rwkv6's per-head norm, and the
   logits, position by position against the decode step's; it prints the
   first op that differs (every earlier op equal), or that none does;
5. the reductions those families ran in PyTorch before (the router's
   softmax over the experts, the top-k sum, the sum over k of the experts'
   results, rwkv6's per-head mean of squares, MLA's softmax over the
   cache): row 0 among M = 2 .. 16 rows against row 0 alone, and the
   batched products by torch.bmm (cuBLAS) the same way.

Exit 0 when it ran; what it found is printed, not judged.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]

MS = (2, 4, 8, 16)
# the ops Recorder keeps of one dense layer: 2 norms, q, k, v, attention, o, swiglu, mlp
# (the final norm comes after the last layer's)
OPS_PER_LAYER = 9
TRIALS = 200
MAX_NEW = 48


def product_shapes() -> list:
    """(label, K, N) of every product of the serving forward at the 8B, 1B
    and 70B rank shapes (bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.parallel.shard import Shard

    out = []
    for label, name, tp in (("8B", "llama3-8b", 1), ("1B", "llama3-1b", 1),
                            ("70B-tp3-r0", "llama3-70b", 3), ("70B-tp4-r0", "llama3-70b", 4)):
        c = Shard(get_config(name), 0, tp).local_cfg if tp > 1 else get_config(name)
        d, hd = c.d_model, c.head_dim
        out += [(f"{label} wq", d, c.n_heads * hd), (f"{label} wk", d, c.n_kv_heads * hd),
                (f"{label} wo", c.n_heads * hd, d), (f"{label} wd", c.d_ff, d),
                (f"{label} lm_head", d, c.vocab_size), (f"{label} swiglu", d, c.d_ff)]
    return out


def check_products(torch, card) -> None:
    import chip_smoke
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = chip_smoke.Timer(torch)
    for label, K, N in product_shapes():
        x = torch.randn((max(MS), K), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5).bfloat16()
        if label.endswith("swiglu"):
            wu = (torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5).bfloat16()
            kinds = {"fused_swiglu kernel": lambda m: ops.fused_swiglu(x[:m], w, wu)}
        else:
            kinds = {"stream_matmul kernel": lambda m: ops.stream_matmul(x[:m], w),
                     "torch.matmul": lambda m: x[:m] @ w}
        for kind, f in kinds.items():
            alone = f(1)[0]
            res = []
            for m in MS:
                row = f(m)[0]
                res.append(f"M {m}: {int((row != alone).sum())} of {N} differ"
                           f" (max {float((row.float() - alone.float()).abs().max()):.3g})")
            times = ", ".join(f"M {m} {timer(lambda m=m: f(m)):.4f} ms" for m in (1, 8, 16))
            print(f"products: {label} [M, {K}] @ [{K}, {N}] bf16 ({kind}), row 0 against the "
                  f"row alone: " + "; ".join(res) + f"; time {times} on {card}", flush=True)


def check_attention(torch, card) -> None:
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(1)
    S = 512
    for label, hq, hkv, hd in (("8B", 32, 8, 128), ("70B-tp3-r0", 24, 3, 128)):
        moved = 0
        worst = 0.0
        for _ in range(TRIALS):
            q = torch.randn((1, 1, hq, hd), generator=gen, device="cuda").bfloat16()
            k = torch.randn((1, S, hkv, hd), generator=gen, device="cuda").bfloat16()
            v = torch.randn((1, S, hkv, hd), generator=gen, device="cuda").bfloat16()
            L = int(torch.randint(16, 400, (1,), generator=gen, device="cuda"))
            mask = torch.zeros((1, 1, S), dtype=torch.bool, device="cuda")
            mask[..., :L + 1] = True
            k2, v2, mask2 = k.clone(), v.clone(), mask.clone()
            k2[:, L + 1], v2[:, L + 1] = k[:, L], v[:, L]
            mask2[..., L], mask2[..., L + 1] = False, True
            a, b = ops.tree_attention(q, k, v, mask), ops.tree_attention(q, k2, v2, mask2)
            moved += not torch.equal(a, b)
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        print(f"attention: tree_attention at {label} (Hq {hq}, Hkv {hkv}, hd {hd}, S {S}) bf16, "
              f"a query's last key moved one row on: {moved} of {TRIALS} outputs differ (max "
              f"{worst:.3g}) on {card}", flush=True)


def _row(tag, t, b, i, n):
    """Row i of batch row b of a record made among n rows per batch row."""
    if tag == "swiglu":
        return t[b * n + i]
    if tag == "att" and t.dim() == 3:  # decode_attention: [B, Hq, hd]
        return t[b]
    return t[b, i]


class Recorder:
    """Per call of the target's forward: every op's output in call order."""

    def __init__(self, torch):
        import repro_torch.models.attention as at
        import repro_torch.models.transformer as tr
        from repro_torch.kernels import ops

        self.calls, self.on = None, False
        self._undo = []
        for mod, name, tag in ((at, "_project_qkv", "qkv"), (at, "_out_proj", "o"),
                               (ops, "tree_attention", "att"), (ops, "decode_attention", "att"),
                               (ops, "fused_swiglu", "swiglu"), (tr, "_mlp_apply", "mlp"),
                               (ops, "rms_norm", "norm")):
            self._wrap(mod, name, tag)

    def _wrap(self, mod, name, tag):
        fn = getattr(mod, name)

        def rec(*a, **k):
            out = fn(*a, **k)
            if self.on:
                if tag == "qkv":
                    self.calls[-1] += [("q", out[0].clone()), ("k", out[1].clone()),
                                       ("v", out[2].clone())]
                else:
                    self.calls[-1].append((tag, out.clone()))
            return out

        setattr(mod, name, rec)
        self._undo.append((mod, name, fn))

    def start(self):
        self.calls.append([])
        self.on = True

    def stop(self):
        self.on = False

    def uninstall(self):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)


def check_engine(torch, card) -> None:
    import chip_smoke
    from repro_torch.core.engine import SpecConfig, SpecEngine
    from repro_torch.data import make_request_stream
    from repro_torch.models.api import Model, make_model

    T = make_model(chip_smoke.bf16_config("llama3-8b"), "cuda")
    D = make_model(chip_smoke.bf16_config("llama3-1b"), "cuda")
    tp, dp = chip_smoke.peaked(T.init(0)), chip_smoke.peaked(D.init(1))
    prompts = list(make_request_stream(T.cfg.vocab_size, 16, 1, 3))[:2]
    eng = SpecEngine(T, D, SpecConfig(bs=8, w=4, c=2, d=2, max_new=MAX_NEW), S_max_t=512,
                     S_max_d=512)
    rec = Recorder(torch)
    for pi, prompt in enumerate(prompts):
        P = prompt.shape[1]
        # the greedy decode: its prefill, then a decode step per position
        rec.calls = []
        rec.start()
        lg, cache = T.prefill(tp, prompt, S_max=512)
        rec.stop()
        dec_logits = [lg[:, -1]]
        toks = [lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
        for _ in range(MAX_NEW - 1):
            rec.start()
            lg, cache = T.decode_step(tp, cache, toks[-1], 512)
            rec.stop()
            dec_logits.append(lg[:, -1])
            toks.append(lg[:, -1].argmax(-1, keepdim=True).to(torch.int32))
        greedy = torch.cat(toks, 1)[0].tolist()
        gaps = [float(t.float().topk(2).values.diff().abs()) for t in
                (x[0] for x in dec_logits)]
        dec = rec.calls
        # the speculative run, recording the target's verifies
        verifies = []
        spec_forward = Model.spec_forward

        def recorded(self, params, c, tokens, positions, rows, mask):
            if self is not T:
                return spec_forward(self, params, c, tokens, positions, rows, mask)
            rec.start()
            out = spec_forward(self, params, c, tokens, positions, rows, mask)
            rec.stop()
            verifies.append((tokens.clone(), positions.clone(), out[0].clone()))
            return out

        rec.calls = []
        Model.spec_forward = recorded
        try:
            out, _ = eng.session(tp, dp).generate(prompt)
        finally:
            Model.spec_forward = spec_forward
        spec = out[0]
        j = next((i for i, (a, b) in enumerate(zip(spec, greedy)) if a != b), None)
        print(f"engine (8B + 1B bf16) prompt {pi}: " + (
            f"the speculative output equals the greedy decode ({len(spec)} tokens)" if j is None
            else f"the speculative output leaves the greedy decode at position {j} (spec "
            f"{spec[j:j + 3]}, greedy {greedy[j:j + 3]}); the decode's top-2 logit gap there "
            f"{gaps[j]:.4g}") + f" on {card}", flush=True)
        # position p's token is the input at sequence row P - 1 + p (p = 0: the prompt's last)
        inputs = [int(prompt[0, -1])] + greedy
        found, equal_logits, compared = None, 0, 0
        for p in range(len(spec)):
            ref_ops = dec[0] if p == 0 else dec[p]
            ref_n, ref_i = (P, P - 1) if p == 0 else (1, 0)
            hit = None
            for vi, (tk, ps, lgt) in enumerate(verifies):
                nodes = [h for h in range(tk.shape[1])
                         if int(ps[0, h]) == P - 1 + p and int(tk[0, h]) == inputs[p]]
                if nodes:
                    hit = (vi, nodes[0], tk.shape[1], lgt)
            if hit is None:
                continue
            vi, h, n, lgt = hit
            compared += 1
            want = dec_logits[p][0]
            equal_logits += bool(torch.equal(lgt[0, h], want))
            if found is None:
                for li, ((tag, a), (_, v)) in enumerate(zip(ref_ops, rec.calls[vi])):
                    ra, rv = _row(tag, a, 0, ref_i, ref_n), _row(tag, v, 0, h, n)
                    if not torch.equal(ra, rv):
                        found = (p, li // OPS_PER_LAYER, tag, float((ra.float() - rv.float()).abs().max()),
                                 vi, n)
                        break
        if found:
            p, layer, tag, diff, vi, n = found
            print(f"engine (8B + 1B bf16) prompt {pi}: the first difference between a verify and "
                  f"the greedy decode: position {p} (sequence row {P - 1 + p}), layer {layer}, op "
                  f"{tag} (max |diff| {diff:.3g}; every earlier op and position equal), in "
                  f"verify {vi} of {n} rows against " + ("the prefill of the prompt's "
                                                          f"{P} rows" if p == 0 else
                                                          "a decode step (1 row)"), flush=True)
        print(f"engine (8B + 1B bf16) prompt {pi}: {equal_logits} of {compared} positions found on "
              f"a verify's path have logits bit for bit the decode's", flush=True)
        del dec, verifies
    rec.uninstall()


# (label, config, layers kept, note): one layer of each family past the shared blocks
FAMILY_LAYERS = (("dsmoe", "deepseek-moe-16b", 2, "layer 0 dense, layer 1 moe"),
                 ("mixtral", "mixtral-8x22b", 1, "a moe layer"),
                 ("minicpm3", "minicpm3-4b", 1, "an MLA layer"),
                 ("zamba2", "zamba2-2.7b", 6, "a unit: 6 mamba2 layers + the shared block"),
                 ("rwkv6", "rwkv6-7b", 1, "a time-mix + channel-mix layer"))
FAMILY_PROMPT, FAMILY_STEPS = 16, 8


class OpRecorder:
    """Per forward: every recorded op's output as [rows, -1], rows the
    forward's sequence positions (B = 1), in call order."""

    def __init__(self):
        import repro_torch.models.api as api
        import repro_torch.models.mamba2 as m2
        import repro_torch.models.moe as moe
        import repro_torch.models.rwkv6 as rk
        from repro_torch.kernels import ops

        self.calls, self.on, self.n, self._undo = [], False, 1, []
        seq = self._seq
        for mod, name, tag, rows in (
                (ops, "stream_matmul", "product", seq), (ops, "stream_bmm", "batched", None),
                (ops, "rms_norm", "norm", seq), (ops, "fused_swiglu", "swiglu", seq),
                (ops, "latent_attention", "latent_attention", seq),
                (ops, "tree_attention", "attention", seq),
                (ops, "decode_attention", "attention", seq),
                (moe, "route", "route weights", lambda out: seq(out[1])),
                (moe, "_combine", "combine", seq), (m2, "_causal_conv", "conv",
                                                    lambda out: seq(out[0])),
                (m2, "_ssd_stepwise", "ssd scan", lambda out: seq(out[0])),
                (rk, "_wkv_scan", "wkv scan", lambda out: seq(out[0])),
                (rk, "_head_norm", "head norm", seq), (api, "logits_from_hidden", "logits", seq)):
            self._wrap(mod, name, tag, rows)
        # the experts' results per row (the rows of their buffer that each row reads)
        combine = moe._combine

        def experts(hflat, dest, w):
            if self.on:
                self.calls[-1].append(("experts", seq(hflat[dest])))
            return combine(hflat, dest, w)

        moe._combine = experts
        self._undo.append((moe, "_combine", combine))
        # the experts' batched products fill buffer slots, not rows: not recorded as rows
        batched = moe.project_batched

        def slots(x, w):
            on, self.on = self.on, False
            try:
                return batched(x, w)
            finally:
                self.on = on

        moe.project_batched = slots
        self._undo.append((moe, "project_batched", batched))

    def _seq(self, t):
        """t's leading dims are (B = 1, rows, ...) or (rows, ...): [rows, -1]."""
        return t.reshape(self.n, -1)

    def _batched(self, out):
        """stream_bmm's [G, M, N] with M the forward's rows (rwkv6, MLA) as
        [rows, -1] (an expert buffer's M is its capacity: slots, not rows;
        its products are recorded through the experts' per-row results)."""
        G, M, N = out.shape
        return None if M != self.n else out.permute(1, 0, 2).reshape(self.n, -1)

    def _wrap(self, mod, name, tag, rows):
        fn = getattr(mod, name)
        rows = rows or self._batched

        def rec(*a, **k):
            out = fn(*a, **k)
            if self.on:
                r = rows(out)
                if r is not None:
                    self.calls[-1].append((tag, r.clone()))
            return out

        setattr(mod, name, rec)
        self._undo.append((mod, name, fn))

    def start(self, n):
        self.n = n
        self.calls.append([])
        self.on = True

    def stop(self):
        self.on = False

    def uninstall(self):
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)


def probe_family(torch, model, params, prompt, n: int, S_max: int = 512):
    """Part 4 for one model on its device: the greedy decode of ``n`` tokens
    after ``prompt`` [1, P], step by step, against the same tokens in one
    forward from the prefilled cache, op by op.  Returns (first difference
    (position, op index, tag, max |diff|) or None, op outputs compared, the
    ops recorded, what the one forward was)."""
    dev = model.device
    rec = OpRecorder()
    try:
        P = prompt.shape[1]
        lg, cache = model.prefill(params, prompt, S_max=S_max)
        toks = [lg[:, -1:].argmax(-1).to(torch.int32)]
        rec.calls = []
        for _ in range(n):  # the greedy decode, a step a position
            rec.start(1)
            lg, cache = model.decode_step(params, cache, toks[-1], S_max)
            rec.stop()
            toks.append(lg[:, -1:].argmax(-1).to(torch.int32))
        steps = rec.calls
        tokens = torch.cat(toks[:n], 1)
        _, cache = model.prefill(params, prompt, S_max=S_max)
        rec.calls = []
        rec.start(n)
        if model.uses_chain_spec:
            model.chain_forward(params, cache, tokens, n, S_max)
            how = f"a chain forward of the {n} tokens"
        else:
            pos = torch.arange(P, P + n, dtype=torch.int32, device=dev)[None]
            mask = torch.arange(S_max, device=dev)[None, None, :] <= pos[:, :, None]
            model.spec_forward(params, cache, tokens, pos, pos, mask)
            how = f"a verify of the {n} tokens along a chain"
        rec.stop()
    finally:
        rec.uninstall()
    verify = rec.calls[0]
    tags = [t for t, _ in verify]
    found, compared = None, 0
    for i, step in enumerate(steps):
        if [t for t, _ in step] != tags:
            return (i, -1, "the op sequence", 0.0), compared, sorted(set(tags)), how
        for j, ((tag, a), (_, b)) in enumerate(zip(step, verify)):
            compared += 1
            if not torch.equal(a[0], b[i]):
                if found is None or (j, i) < (found[1], found[0]):
                    found = (i, j, tag, max_diff(a[0], b[i]))
                break
    return found, compared, sorted(set(tags)), how


def check_families(torch, card) -> None:
    """Part 4 of the module docstring, on the card."""
    import dataclasses

    import chip_smoke
    from repro_torch.data import make_request_stream
    from repro_torch.models.api import make_model

    for label, name, layers, note in FAMILY_LAYERS:
        cfg = dataclasses.replace(chip_smoke.bf16_config(name), n_layers=layers)
        if cfg.n_experts:  # drop-free: a decode step of one row never drops
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
        model = make_model(cfg, "cuda")
        params = chip_smoke.peaked(model.init(0))
        prompt = list(make_request_stream(cfg.vocab_size, FAMILY_PROMPT, 1, 1))[0]
        found, compared, ops_seen, how = probe_family(torch, model, params, prompt,
                                                      FAMILY_STEPS)
        where = f"{name} ({note}, full width, bf16)"
        if found is None:
            print(f"family {label}: {where}: {how} against {FAMILY_STEPS} decode steps: no "
                  f"differing op ({compared} op outputs compared, each row bit for bit; ops "
                  f"{ops_seen}) on {card}", flush=True)
        else:
            i, j, tag, diff = found
            print(f"family {label}: {where}: {how} against {FAMILY_STEPS} decode steps: the "
                  f"first differing op is op {j} ({tag}, max |diff| {diff:.3g}; every earlier "
                  f"op equal) at position {i} (ops {ops_seen}) on {card}", flush=True)
        del model, params
        torch.cuda.empty_cache()


def max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_reductions(torch, card) -> None:
    """Part 5 of the module docstring."""
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def probe(label, make, fn, dtype):
        x = make(max(MS))
        alone = fn(x[:1])
        differ = [M for M in MS if not torch.equal(fn(x[:M])[:1], alone)]
        print(f"reductions: {label} {str(dtype).removeprefix('torch.')}: row 0 differs from "
              f"itself alone at M {differ or 'none'} of {list(MS)} on {card}", flush=True)

    mask_s = torch.rand((1, 1, 512), generator=gen, device="cuda") < 0.2
    for dtype in (torch.float32, torch.bfloat16):
        probe("router softmax over 64 experts", lambda M: randn(M, 64),
              lambda x: torch.softmax(x, dim=-1), torch.float32)
        probe("top-6 weight sum", lambda M: randn(M, 6).abs(),
              lambda x: x.sum(-1, keepdim=True), torch.float32)
        probe("experts' results summed over k 6 (d 2048)",
              lambda M: randn(M, 6, 2048, dtype=dtype), lambda x: x.sum(1), dtype)
        probe("rwkv6 per-head mean of squares (64 heads of 64)",
              lambda M: randn(M, 64, 64), lambda x: (x * x).mean(-1, keepdim=True),
              torch.float32)
        probe("MLA softmax over 512 keys (40 heads)", lambda M: randn(1, 40, M, 512),
              lambda x: torch.softmax(torch.where(mask_s[:, None].expand(1, 1, x.shape[2], 512),
                                                  x, -1e30), dim=-1).transpose(0, 2), dtype)
        for label, G, K, N in (("dsmoe experts", 64, 2048, 1408), ("rwkv6 w_rkvg", 4, 4096, 4096),
                               ("minicpm3 w_uk", 40, 64, 256)):
            w = randn(G, K, N, dtype=dtype) * K ** -0.5
            probe(f"torch.bmm {label} G{G} K{K} N{N}", lambda M: randn(M, G, K, dtype=dtype),
                  lambda x: torch.bmm(x.transpose(0, 1).contiguous(), w).transpose(0, 1), dtype)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bf16_invariance: needs a CUDA device")
    from repro_torch.kernels.build import build_all

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi, flush=True)
    print(f"kernels built in {build_all():.1f} s", flush=True)
    with torch.no_grad():
        check_products(torch, card)
        check_attention(torch, card)
        check_engine(torch, card)
        check_families(torch, card)
        check_reductions(torch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
