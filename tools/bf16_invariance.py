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
    return 0


if __name__ == "__main__":
    sys.exit(main())
