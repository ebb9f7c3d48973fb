#!/usr/bin/env bash
# The CNN runners' statistical check on one card: the Fashion runner's
# cnn, hybrid and vit arms on the committed digit shard at the JAX runs'
# flags (scripts/bench_chain_r4e.sh:42-45: --dataset mnist32, d 128, the
# four families, 60 epochs, --eval_subprocess --scan_epochs
# --require_real), N trials per (arch, family) cell, each trial one
# process of the port's sweep driver (cliffordtpu_torch.scripts.sweep).
# The three arms run side by side; the vit arm, the one the card's time
# bounds, runs as two sweep slices by trial range into its one outdir
# (from 4 trials on, so that each slice names its trials -trial{n}), and
# a last pass of the whole sweep (every trial skipped) aggregates them.
# BUDGET seconds (0: none) stop the slices, and BUDGET / 6 more the last
# passes (which also run what the slices left), in time for the call's
# end; a trial running then is killed, and re-running the command resumes.
# Where matplotlib is missing the drawing halves go through
# chip_smoke.py's pyplot recorder.
#
#   scripts/torch_sweep_cnn.sh OUTDIR [N_TRIALS [EPOCHS [BUDGET]]]
#
# Then hold each arm against the JAX run:
#   python3 scripts/torch_compare_sweep.py --cnn OUTDIR artifacts
# Extra runner flags (a CPU rehearsal: --device cpu and small limits)
# come from $SWEEP_EXTRA; $SWEEP_DEVICE goes to the sweep's --device.
set -eo pipefail
out=$(realpath -m "${1:?usage: $0 OUTDIR [N_TRIALS [EPOCHS [BUDGET]]]}")
n=${2:-8}
epochs=${3:-60}
budget=${4:-0}
root=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$out"
cd "$root"
export CLIFFORDTPU_DATA_DIR="$root/tests/data"
if [ -z "${SWEEP_DEVICE:-}" ]; then
  python3 -c "from cliffordtpu_torch.kernels import build; build.build_all()"
fi
if ! python3 -c "import matplotlib" 2>/dev/null; then
  rec=$(mktemp -d)
  trap 'rm -rf "$rec"' EXIT
  python3 - "$rec" <<'PY'
import os
import sys

from chip_smoke import PLOT_RECORDER

os.makedirs(os.path.join(sys.argv[1], "matplotlib"))
for name, text in PLOT_RECORDER.items():
    with open(os.path.join(sys.argv[1], "matplotlib", name), "w") as f:
        f.write(text)
PY
  export PYTHONPATH="$rec${PYTHONPATH:+:$PYTHONPATH}"
fi
# shellcheck disable=SC2206
extra=(${SWEEP_EXTRA:-})
sweep() {  # sweep <seconds, 0: no limit> <arch> <start_trial> <n_trials>
  local limit=$1
  shift
  timeout "$limit" python3 -m cliffordtpu_torch.scripts.sweep \
    --runner fashion_train --dataset mnist32 --outdir "$out/real_digits_$1" \
    --distributions clifford gaussian gaussian_nol2 powerspherical \
    --latent_dims 128 --start_trial "$2" --n_trials "$3" \
    --trial_timeout 1200 ${SWEEP_DEVICE:+--device "$SWEEP_DEVICE"} -- \
    --arch "$1" --epochs "$epochs" --require_real --eval_subprocess \
    --scan_epochs "${extra[@]}"
}
half=$(( n >= 4 ? (n + 1) / 2 : n ))
t0=$(date +%s)
pids=()
for slice in "cnn 1 $n" "hybrid 1 $n" "vit 1 $half" \
             "vit $((half + 1)) $((n - half))"; do
  read -r arch start count <<< "$slice"
  [ "$count" -gt 0 ] || continue
  sweep "$budget" "$arch" "$start" "$count" \
    > "$out/sweep_${arch}_from${start}.log" 2>&1 &
  pids+=($!)
done
rc=0
for p in "${pids[@]}"; do
  wait "$p" || rc=1
done
echo "slices done after $(( $(date +%s) - t0 )) s (rc $rc)"
pids=()
for arch in cnn hybrid vit; do
  sweep $(( budget / 6 )) "$arch" 1 "$n" \
    > "$out/sweep_${arch}_aggregate.log" 2>&1 &
  pids+=($!)
done
for p in "${pids[@]}"; do
  wait "$p" || rc=1
done
for arch in cnn hybrid vit; do
  tail -n 1 "$out/sweep_${arch}_aggregate.log"
done
echo "total $(( $(date +%s) - t0 )) s"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader || true
exit $rc
