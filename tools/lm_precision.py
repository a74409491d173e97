"""Measure how far the LM stack's bf16 forward strays on its own: decode
steps against one train-mode forward, and bf16 against f32 compute.

    python3 tools/lm_precision.py [--arch qwen3-1.7b] [--steps 16]
                                  [--reduced] [--device cpu]

Builds ``--arch`` (full width unless ``--reduced``) from a seeded init,
prefills chip_smoke.py's token-stream prompts (8 x 128) into a cache and
runs ``--steps`` greedy decode steps, then one train-mode forward over
prompt + output.  It does this twice, with the model's compute dtype set
to f32 and then to bf16 (the module constant ``COMPUTE_DTYPE`` of
``models.layers`` and ``models.transformer``, patched in this process
only), and prints one JSON line for each: the decode logits' error
against the full forward, the last step's hidden state after every block
relative to the full forward's, and the residual stream's RMS.  A last
line holds the bf16 full forward's logits against the f32 one's.  An f32
run that agrees shows the two paths compute the same function; the bf16
lines show the rounding both paths carry.  Runs on the card unless
``--device cpu``; prints the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _stats(got, want) -> dict:
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    return {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
            "max_abs_logit": float(ref.max()),
            "mean_abs_logit": float(ref.mean()),
            "max_err_over_2e-2_bound": float((err / (0.02 + 0.02 * ref)).max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch._device import resolve_device
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    dev = resolve_device(args.device)
    cfg = (reduced_config if args.reduced else get_config)(args.arch)
    b, s0, steps = cs.QWEN3["batch"], cs.QWEN3["prompt"], args.steps
    model = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    prompts = TokenStream(cfg.vocab_size, b, s0, seed=0).batch_at(
        0, device=dev)["tokens"]
    hidden: list = []
    block = tf._apply_attn_mlp

    def recorded(*a, **kw):
        x, cache = block(*a, **kw)
        hidden.append(x[:, -1].float())
        return x, cache

    def run(dtype):
        layers.COMPUTE_DTYPE = tf.COMPUTE_DTYPE = dtype
        caches = tf.init_caches(cfg, b, s0 + steps, device=dev)
        caches = {k: {n: t.to(dtype) for n, t in v.items()}
                  for k, v in caches.items()}
        with torch.inference_mode():
            lp, caches = tf.forward(model, cfg, prompts, mode="prefill",
                                    caches=caches)
            dec, tok = [lp[:, -1]], lp[:, -1].float().argmax(-1)
            toks = [tok]
            for i in range(steps):
                if i == steps - 1:
                    hidden.clear()
                    tf._apply_attn_mlp = recorded
                ld, caches = tf.forward(model, cfg, tok[:, None],
                                        mode="decode", caches=caches,
                                        pos=s0 + i)
                tf._apply_attn_mlp = block
                dec.append(ld[:, 0])
                tok = ld[:, 0].float().argmax(-1)
                toks.append(tok)
            h_dec = list(hidden)
            hidden.clear()
            seq = torch.cat([prompts, torch.stack(toks, 1)[:, :steps]], 1)
            tf._apply_attn_mlp = recorded
            full, _ = tf.forward(model, cfg, seq, mode="train")
            tf._apply_attn_mlp = block
        h_full = list(hidden)
        hidden.clear()
        print(json.dumps({
            "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "compute": str(dtype), "steps": steps,
            "decode_vs_full": _stats(torch.stack(dec, 1), full[:, s0 - 1:]),
            "hidden_rel_err_by_block": [
                float((a - c).norm() / c.norm()) for a, c in zip(h_dec,
                                                                 h_full)],
            "hidden_rms_by_block": [float(c.pow(2).mean().sqrt())
                                    for c in h_full]}), flush=True)
        return seq, full

    seq, full32 = run(torch.float32)
    run(torch.bfloat16)
    with torch.inference_mode():
        full16, _ = tf.forward(model, cfg, seq, mode="train")
    print(json.dumps({"bf16_vs_f32_full_forward": _stats(full16, full32)}),
          flush=True)
    if dev.type == "cuda":
        print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
