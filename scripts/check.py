"""One-command local CI with a persisted evidence artifact.

Runs every tier (CPU suite on the simulated mesh, examples, multi-device
dryrun, and — when a CUDA GPU is attached — chip_smoke.py, which runs the
on-card test tier, then the SNR-gated bench) and writes a results JSON so
a verification run leaves a record.

Every tier is a child process, one at a time, and this parent never
imports JAX: a JAX process reserves most of a card's memory, so two at
once on one card fail.

    python scripts/check.py [--out check_results.json] [--skip-gpu]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CPU_ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "")
                  + " --xla_force_host_platform_device_count=8").strip(),
}

EXAMPLES = ["fm_receiver.py", "channelizer.py", "yaml_block.py",
            "distributed_pipeline.py", "sharded_channelizer.py",
            "live_flagship.py", "retune_live_receiver.py"]


def run(cmd, timeout, env=None, label=""):
    t0 = time.monotonic()
    try:
        p = subprocess.run(cmd, cwd=ROOT, env=env or os.environ,
                           capture_output=True, text=True, timeout=timeout)
        ok = p.returncode == 0
        stdout = p.stdout or ""
        out = stdout + (p.stderr or "")
    except subprocess.TimeoutExpired as e:
        ok = False
        stdout = ""
        out = f"TIMEOUT after {timeout}s\n" + str(e.output or "")[-2000:]
    return {
        "label": label or " ".join(cmd),
        "ok": ok,
        "seconds": round(time.monotonic() - t0, 1),
        "tail": out[-1500:],
        # full stdout kept OFF the artifact but available to callers that
        # must parse structured output (the bench JSON line) — the 1500-char
        # tail alone can truncate it behind stderr noise.
        "_stdout": stdout,
    }


def pytest_counts(tail: str):
    m = re.search(r"(\d+) passed", tail)
    f = re.search(r"(\d+) failed", tail)
    return {"passed": int(m.group(1)) if m else 0,
            "failed": int(f.group(1)) if f else 0}


def gpu_attached() -> bool:
    """Asks a child process, which exits before the next tier starts."""
    probe = run([sys.executable, "-c",
                 "import sys; from newsched_tpu.utils.platform import "
                 "gpu_backend; sys.exit(0 if gpu_backend() else 1)"],
                timeout=300, label="gpu probe")
    return probe["ok"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "check_results.json"),
                    help="results JSON path")
    ap.add_argument("--skip-gpu", action="store_true")
    args = ap.parse_args()

    results: dict = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "tiers": {},
    }
    failed = []

    def record(name, res, extra=None):
        res.pop("_stdout", None)
        results["tiers"][name] = {**res, **(extra or {})}
        status = "ok" if res["ok"] else "FAILED"
        print(f"[{status}] {name} ({res['seconds']}s)", flush=True)
        if not res["ok"]:
            failed.append(name)
            print(res["tail"][-1200:], flush=True)

    print("== CPU suite (simulated 8-device mesh) ==", flush=True)
    r = run([sys.executable, "-m", "pytest", "tests/", "-q"],
            timeout=1800, env=CPU_ENV, label="cpu suite")
    record("cpu_suite", r, pytest_counts(r["tail"]))

    print("== examples (CPU) ==", flush=True)
    for ex in EXAMPLES:
        # on the CPU even when a GPU is attached: CI stays fast and never
        # competes with another process for the card
        r = run([sys.executable, os.path.join("examples", ex)],
                timeout=900, env=CPU_ENV, label=f"example {ex}")
        record(f"example:{ex}", r)

    print("== multi-device dryrun (8 virtual devices) ==", flush=True)
    r = run([sys.executable, "__graft_entry__.py", "dryrun", "8"],
            timeout=900, label="dryrun 8")
    record("dryrun_multichip", r)

    if not args.skip_gpu and gpu_attached():
        print("== chip_smoke (chains on the card + tests_gpu) ==", flush=True)
        r = run([sys.executable, "chip_smoke.py"], timeout=1800,
                label="chip_smoke")
        record("chip_smoke", r)

        print("== bench (SNR-gated cells) ==", flush=True)
        r = run([sys.executable, "bench.py"], timeout=1800, label="bench")
        lines = [ln for ln in r.pop("_stdout", "").splitlines()
                 if ln.startswith("{")]
        record("bench", r, {"result": json.loads(lines[-1]) if lines else None})
    else:
        print("== no GPU attached (or --skip-gpu): skipping the GPU tiers ==",
              flush=True)
        results["tiers"]["chip_smoke"] = {"ok": None, "skipped": True}
        results["tiers"]["bench"] = {"ok": None, "skipped": True}

    results["ok"] = not failed
    out = args.out
    with open(out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"\nresults -> {out}")
    if failed:
        print("CHECK FAILED:", ", ".join(failed))
        sys.exit(1)
    print("CHECK OK")


if __name__ == "__main__":
    main()
