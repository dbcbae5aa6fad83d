#!/usr/bin/env python3
"""Data and tensor parallelism over several cards of one machine: the
default training run and the eval render at N ranks against one card.

    python3 tools/dp_multicard.py [--ranks N] [--epochs 2] [--batches 512 2048]
    python3 tools/dp_multicard.py --model M [M ...] [--widths 1024 2048] [--ranks N]

With ``--model`` (tensor parallelism): for each width of ``--widths``,
NeDDF with both trunks that wide (``network.ddf_layer_width``,
``col_layer_width``) on one card (``data=1 model=1``), then at
``trainer.mesh.data=N/M trainer.mesh.model=M`` for each M, the first
batch of ``--batches``; the same records against the one-card run, and
the eval render of the first N-rank run.

For each global batch, ``python -m neddf_tpu_torch.scripts.run`` on the
default config (NeDDF, bunny_smoke, bf16) with ``trainer.mesh.data=1`` and
with ``trainer.mesh.data=N`` (the same seed, so the same draws): the loss
curves side by side (mean and largest relative gap of each step's loss;
bf16, so the two half-batch sums round apart), ms/step and rays/s over
steps 100-199 (epoch 1, which runs no hook) from rank 0's
``train_log.jsonl``, and each run's wall time. Then the eval render of the
N-rank run of the first batch from its newest checkpoint: test camera 0
at full resolution through ``trainer.render_test``, over the N ranks and on one
card (``load_trainer(..., one_process=True)``), after one warm-up
render at downsampling 8: s/image and PSNR. Prints the card's name and
power limit and writes everything to ``chiprun_out/dp_multicard/``.
Needs N cards (``torch.cuda.device_count()``); nothing runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "chiprun_out" / "dp_multicard"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def train(run_dir: Path, ranks: int, batch: int, epochs: int, model: int = 1,
          extra=()) -> dict:
    """One ``scripts/run.py`` run over ``ranks`` ranks, ``model`` of them
    per data row; its records and wall time."""
    if run_dir.exists():
        shutil.rmtree(run_dir)
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "neddf_tpu_torch.scripts.run",
         f"trainer.mesh.data={ranks // model}", f"trainer.mesh.model={model}",
         f"trainer.batch_size={batch}", f"trainer.epoch_max={epochs}",
         f"hydra.run.dir={run_dir}", *extra], cwd=REPO, capture_output=True, text=True)
    wall = time.perf_counter() - start
    if proc.returncode:
        raise SystemExit(f"{run_dir.name}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    records = [json.loads(x) for x in (run_dir / "train_log.jsonl").read_text().splitlines()]
    steady = [r["seconds"] for r in records if 100 <= r["iteration"] < 200]
    return {"wall_s": wall, "steps": len(records), "loss": [r["loss"] for r in records],
            "psnr": [r["psnr"] for r in records],
            "ms_per_step": 1e3 * statistics.mean(steady),
            "rays_per_s": batch / statistics.mean(steady)}


def eval_rank(run_dir: str, epoch: int, out: str, one_process: bool = False) -> None:
    """Camera 0 of the test split at full resolution through
    ``render_test`` (after a warm-up at downsampling 8), over the
    snapshot's ranks or in ``one_process``; rank 0 writes the seconds and
    the PSNR."""
    import torch

    from neddf_tpu_torch.scripts.run_eval import load_trainer
    from neddf_tpu_torch.training.metrics import peak_signal_noise_ratio

    trainer = load_trainer(Path(run_dir), epoch, one_process=one_process)
    scratch = Path(out).with_suffix(".render")
    trainer.render_test(scratch, 0, 8)
    torch.cuda.synchronize()
    start = time.perf_counter()
    image = trainer.render_test(scratch, 0, 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    gt = trainer.dataset[0]["rgb_images"].astype("uint8")
    if trainer.rank == 0:
        Path(out).write_text(json.dumps({
            "seconds": seconds, "psnr": peak_signal_noise_ratio(image, gt),
            "world": trainer.world or 1}))


def evaluate(run_dir: Path, epoch: int, ranks: int) -> dict:
    """``eval_rank`` over the run's ranks and on one card."""
    from neddf_tpu_torch.parallel import launch

    got = {}
    out = OUT / f"eval_{ranks}.json"
    launch(eval_rank, (str(run_dir), epoch, str(out)), ranks, "cuda", run_dir)
    got[ranks] = json.loads(out.read_text())
    out = OUT / "eval_1.json"
    eval_rank(str(run_dir), epoch, str(out), one_process=True)
    got[1] = json.loads(out.read_text())
    return got


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=None, help="default: every card")
    parser.add_argument("--epochs", type=int, default=2, help="trainer.epoch_max")
    parser.add_argument("--batches", type=int, nargs="+", default=[512, 2048])
    parser.add_argument("--model", type=int, nargs="+", default=[1],
                        help="ranks per data row (tensor parallelism, NeDDF), one run each")
    parser.add_argument("--widths", type=int, nargs="+", default=[1024, 2048],
                        help="with --model: both trunks' widths")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("tools/dp_multicard.py: no CUDA card", file=sys.stderr)
        return 1
    ranks = args.ranks or torch.cuda.device_count()
    if ranks < 2 or ranks > torch.cuda.device_count():
        print(f"tools/dp_multicard.py: {ranks} ranks on {torch.cuda.device_count()} cards",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"{card} x {torch.cuda.device_count()} | torch {torch.__version__}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    if any(ranks % m for m in args.model):
        print(f"tools/dp_multicard.py: {ranks} ranks, model={args.model}", file=sys.stderr)
        return 1
    summary = {"card": card, "cards": torch.cuda.device_count(), "ranks": ranks,
               "model": args.model, "runs": {}}
    # (tag, batch, overrides, the N-rank runs' models): the batches of the
    # default config, or with --model the widths at the first batch
    cases = [(f"b{b}", b, [], [1]) for b in args.batches]
    if max(args.model) > 1:
        cases = [(f"w{w}", args.batches[0],
                  [f"network.ddf_layer_width={w}", f"network.col_layer_width={w}"], args.model)
                 for w in args.widths]
    first = None
    for tag, batch, extra, models in cases:
        one = train(OUT / f"train_{tag}_r1", 1, batch, args.epochs, 1, extra)
        print(f"{tag}, one card: {one['ms_per_step']:.2f} ms/step, {one['rays_per_s']:.0f} "
              f"rays/s, {one['steps']} steps in {one['wall_s']:.1f} s of wall | {card}",
              flush=True)
        for model in models:
            name = tag if model == 1 else f"{tag}_m{model}"
            runs = {1: one, ranks: train(OUT / f"train_{name}_r{ranks}", ranks, batch,
                                         args.epochs, model, extra)}
            first = first or OUT / f"train_{name}_r{ranks}"
            n = ranks
            print(f"{name}, {n} rank(s) (data {n // model} x model {model}): "
                  f"{runs[n]['ms_per_step']:.2f} ms/step, "
                  f"{runs[n]['rays_per_s']:.0f} rays/s (steps 100-199, rank 0's records), "
                  f"{runs[n]['steps']} steps in {runs[n]['wall_s']:.1f} s of wall | {card}",
                  flush=True)
            gaps = [abs(a - b) / abs(b) for a, b in zip(runs[ranks]["loss"], runs[1]["loss"])]
            psnr_gap = abs(statistics.mean(runs[ranks]["psnr"][-50:])
                           - statistics.mean(runs[1]["psnr"][-50:]))
            print(f"{name}: {ranks} ranks against one card: loss gap mean "
                  f"{statistics.mean(gaps):.4g}, max {max(gaps):.4g}; train PSNR of the last 50 "
                  f"steps {statistics.mean(runs[ranks]['psnr'][-50:]):.3f} vs "
                  f"{statistics.mean(runs[1]['psnr'][-50:]):.3f} dB (gap {psnr_gap:.3f}); "
                  f"speed-up {runs[1]['ms_per_step'] / runs[ranks]['ms_per_step']:.3f}x",
                  flush=True)
            summary["runs"][name] = {"loss_gap_mean": statistics.mean(gaps),
                                     "loss_gap_max": max(gaps), "psnr_gap_last50": psnr_gap,
                                     **{f"ranks_{n}": {k: v for k, v in r.items()
                                                       if k not in ("loss", "psnr")}
                                        for n, r in runs.items()}}
    from neddf_tpu_torch.scripts.run import newest_checkpoint

    got = evaluate(first, int(newest_checkpoint(first).stem.split("_")[1]), ranks)
    for n in sorted(got):
        print(f"eval render, camera 0 at full resolution, {n} rank(s): "
              f"{got[n]['seconds']:.3f} s/image, {got[n]['psnr']:.4f} dB | {card}", flush=True)
    summary["eval"] = got
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    for run in OUT.glob("train_*"):
        for ckpt in run.rglob("*.ckpt"):
            ckpt.unlink()
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
