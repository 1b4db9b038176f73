"""Training launcher (port of ``repro.launch.train``, one device).

    python -m repro_torch.launch.train --arch stablelm_3b --reduced \
        --steps 200 --device cpu
    python -m repro_torch.launch.train --arch mamba2_370m --reduced \
        --resume auto

The flags are the reference's, with ``--device`` (default: the card;
``cpu`` runs the kernels' plain versions); the printed lines are the
reference's.
"""
from __future__ import annotations

import argparse

from ..configs import ARCH_IDS, get_config, get_reduced
from ..data.pipeline import LMBatcher, SyntheticLM
from ..models.zoo import build
from ..train.loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--no-projection", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build(cfg)
    print(f"[launch] {cfg.name}: {model.n_params()/1e6:.1f}M params, "
          f"1 device(s)")

    batcher = LMBatcher(SyntheticLM(cfg.vocab), args.batch, args.seq)
    tcfg = TrainConfig(steps=args.steps, lr=args.lr,
                       microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       with_projection=not args.no_projection)
    out = train(model, batcher, tcfg, resume=(args.resume == "auto"),
                device=args.device)
    print(f"[launch] final loss {out['losses'][-1]:.4f}; "
          f"first loss {out['losses'][0]:.4f}")
    wd = out["watchdog"]
    print(f"[launch] step time EWMA {wd['step_time_ewma_s']*1e3:.0f} ms; "
          f"{int(wd['straggler_events_total'])} straggler step(s)")
    for s, dt, ew in out["straggler_events"][:5]:
        print(f"[launch]   straggler step {s}: {dt:.3f}s "
              f"(EWMA was {ew:.3f}s)")
    if out["sparsity"]:
        for k, v in out["sparsity"].items():
            print(f"[sparsity] {k}: {v:.1f}% columns zero")


if __name__ == "__main__":
    main()
