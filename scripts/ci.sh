#!/bin/bash
# One-command CI gate: quick tier + slow tier on the 8-virtual-device CPU
# mesh; --full adds the xslow tail (multi-minute e2e/CV/parity tests).
# The interpret-mode kernel parity tests are part of the quick tier; the
# compiled-kernel tests (marker gpu) and chip_smoke.py run on a GPU.
#
# usage: scripts/ci.sh [--full] [extra pytest args...]
set -e
cd "$(dirname "$0")/.."
FULL=0
if [ "$1" = "--full" ]; then FULL=1; shift; fi
echo "== quick tier =="
time python -m pytest tests/ -q "$@"
echo "== slow tier (without xslow tail) =="
time python -m pytest tests/ -q -m "slow and not xslow" "$@"
if [ "$FULL" = 1 ]; then
  echo "== xslow tail =="
  time python -m pytest tests/ -q -m xslow "$@"
fi
echo "CI green"
