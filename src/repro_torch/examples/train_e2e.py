"""End-to-end driver: pre-train a ~100M-param BERT-Base (the paper's task
family) for a few hundred steps with the full 2-stage 1-bit Adam pipeline
— data stream, LR schedule, auto-warmup, checkpointing — through the
port's launcher.

The port of ``examples/train_e2e.py``.  The default run (bert-base, 300
steps) is for the card; ``--tiny`` (bert-base-smoke, the Sec. 7.1 auto
rule) is a fast sanity run:

  python -m repro_torch.examples.train_e2e [--tiny] [--steps N] \\
      [--device cpu] [--ckpt PATH]

The checkpoint and the history (``onebit_bert_log.json``) are written
under the temporary directory unless ``--ckpt`` says otherwise.
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import run


def main(argv=None) -> dict:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced model / short run (CI-friendly)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join(tmp, "onebit_bert.npz"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    log_file = os.path.join(os.path.dirname(os.path.abspath(args.ckpt)),
                            "onebit_bert_log.json")
    # the reference's run(mesh_shape=(1, 1), base_lr, auto_warmup=True):
    # one dp rank, lr, and warmup_steps=None for the auto rule
    if args.tiny:
        out = run("bert-base-smoke", steps=args.steps or 120, batch=8,
                  seq=64, lr=2e-3, lr_warmup=20, warmup_steps=None,
                  block_size=512, ckpt=args.ckpt, log_file=log_file,
                  log_every=10, device=args.device)
    else:
        # bert-base: 110M params — the paper's BERT-Base pre-training at
        # reduced sequence length
        out = run("bert-base", steps=args.steps or 300, batch=8, seq=128,
                  lr=1e-4, lr_warmup=50, warmup_steps=100, block_size=4096,
                  ckpt=args.ckpt, log_file=log_file, log_every=10,
                  device=args.device)
    print(f"checkpoint written to {args.ckpt}")
    return out


if __name__ == "__main__":
    main()
