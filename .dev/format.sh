#!/usr/bin/env bash
# Format the codebase (the reference ships .dev/climaformat.jl; this is the
# Python analogue). Usage: .dev/format.sh [--check]
set -euo pipefail
cd "$(dirname "$0")/.."
ARGS=()
[[ "${1:-}" == "--check" ]] && ARGS+=(--check --diff)
exec black "${ARGS[@]}" landhydrology tests experiments bench.py chip_smoke.py
