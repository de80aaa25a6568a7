"""End-to-end run of the PyTorch port: train a reduced-config model
with checkpoints, then simulate a crash and resume from the latest
checkpoint, the counterpart of ``examples/train_model.py``.

    PYTHONPATH=src python examples/train_model_torch.py --arch olmoe-1b-7b
    PYTHONPATH=src python examples/train_model_torch.py --device cpu

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    common = ["--arch", args.arch, "--device", args.device]
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        print(f"== phase 1: {args.steps} steps with checkpoints -> {ckpt}")
        train_main(common + ["--steps", str(args.steps), "--ckpt-dir", ckpt,
                             "--ckpt-every", "10"])
        print("\n== phase 2: simulated crash + restart from checkpoint")
        train_main(common + ["--steps", "10", "--ckpt-dir", ckpt, "--resume"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
