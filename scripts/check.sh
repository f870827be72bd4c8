#!/usr/bin/env bash
# One-command local CI (reference: .github/workflows build+test matrix,
# SURVEY.md §3.5 — this sandbox has no GitHub, so the gate is a script).
# Tiers: CPU suite on the simulated 8-device mesh, the examples (each has
# hard assertions), the multi-device dryrun, and — when a GPU is attached —
# chip_smoke.py (which runs the on-card test tier) plus the SNR-gated bench.
#
# All logic lives in scripts/check.py, which also writes a results JSON
# (check_results.json by default; pass --out PATH).
set -euo pipefail
cd "$(dirname "$0")/.."
exec python scripts/check.py "$@"
