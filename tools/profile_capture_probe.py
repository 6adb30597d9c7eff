"""How many of a capture's first device records ``torch.profiler`` drops
late in a long run, and whether ``chip_smoke.py``'s lead of sleep kernels
keeps that loss off the training step's own records.

It runs ``chip_smoke.py``'s phases 1-7 (the state in which phase 8 takes
its profile), trains phase 8's yi-6b loop (16 layers, 8 x 64, 10 steps),
then captures one more step ``--rounds`` times with no lead and as many
with ``chip_smoke.PROFILE_LEAD`` sleep kernels and a sync before it. Each
capture prints the lead kernels it lost, the training ranges whose
device-side annotation is missing, and whether the lookup kernel is there.
On one CUDA device, from the root of the repo:

    python3 tools/profile_capture_probe.py [--rounds 8]
"""
import argparse
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def capture(step, lead: int):
    """One step under the profiler after ``lead`` sleep kernels: (what it
    lost, as a line; whether a range's annotation is missing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        step()
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    kept = sum(cs.SPIN in n for n in dev)
    missing = [r for r in cs.TRAIN_RANGES if r not in dev]
    lookup = sum("fused_lookup" in n for n in dev)
    return (f"lead {lead}: lost {lead - kept} of the lead; ranges missing "
            f"on the device {missing}; lookup kernels {lookup}; device "
            f"records {len(dev) - kept}"), bool(missing)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_capture_probe: needs a CUDA device", file=sys.stderr)
        return 2
    cs.phase1_build()
    cs.phase2_kernels()
    cs.phase3_engine()
    cs.phase4_serve()
    cs.phase5_lm()
    cs.phase6_rwkv()
    cs.phase7_jamba()
    cs.free_weights("probe", "yi-6b training")
    cfg = cs.get_config("yi-6b").replace(num_layers=cs.TRAIN_LAYERS)
    res, _ = cs.train_run("probe", cfg, {**cs.NONE_LAUNCHED,
                                         "kb_fused_lookup": cs.TRAIN_STEPS})
    lost = {0: 0, cs.PROFILE_LEAD: 0}
    for r in range(args.rounds):
        for lead in lost:
            line, missing = capture(res["loop"].step, lead)
            lost[lead] += missing
            print(f"round {r} {line}", flush=True)
            gc.collect()
    print(f"captures that lost a range's device records, by lead: {lost} "
          f"of {args.rounds} each", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
