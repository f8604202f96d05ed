"""End-to-end training on the PyTorch port (the counterpart of
``examples/train_sparse_lm.py``, importing only ``repro_torch``): a
~100M-parameter LM with the Segment block-sparse FFN.

    PYTHONPATH=src python examples/train_sparse_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_sparse_lm_torch.py --steps 5 \\
        --smoke --device cpu --backend reference
"""
import argparse
import math
import time

from repro_torch.api import use_backend
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.runtime import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny dims for a quick check")
    ap.add_argument("--dense", action="store_true",
                    help="a dense SwiGLU FFN instead of the sparse one")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="cuda (the default) or reference (torch oracles)")
    args = ap.parse_args()

    sparse = not args.dense
    if args.smoke:
        cfg = ModelConfig(name="sparse-lm-smoke", family="dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=512,
                          ffn_block_sparse=sparse, ffn_block=32,
                          ffn_density=0.5, remat=False)
        shape = ShapeConfig("smoke", "train", seq_len=64, global_batch=4)
    else:
        # ~100M params: 10L × d640 (attn 1.6M + sparse-ffn ~2.5M active) +
        # 50k vocab embedding
        cfg = ModelConfig(name="sparse-lm-100m", family="dense", n_layers=10,
                          d_model=640, n_heads=10, n_kv=5, d_ff=2560,
                          vocab=50048, ffn_block_sparse=sparse,
                          ffn_block=64, ffn_density=0.5)
        shape = ShapeConfig("train", "train", seq_len=256, global_batch=8)

    model = build_model(cfg, device=args.device)
    print(f"training {cfg.name} on {model.device}: "
          f"~{cfg.param_count()/1e6:.0f}M params, sparse_ffn="
          f"{cfg.ffn_block_sparse} (density {cfg.ffn_density})")
    tcfg = TrainerConfig(steps=args.steps, peak_lr=3e-4,
                         warmup=max(args.steps // 20, 2),
                         ckpt_dir=args.ckpt_dir, ckpt_every=100,
                         log_every=max(args.steps // 20, 1))
    t0 = time.time()
    with use_backend(args.backend):
        out = Trainer(model, cfg, shape, tcfg).run()
    for h in out["history"]:
        print(f"  step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f}")
    print(f"final loss {out['final_loss']:.4f} in {time.time()-t0:.0f}s "
          f"(loss must fall from ~ln(V)={math.log(cfg.padded_vocab):.2f})")


if __name__ == "__main__":
    main()
