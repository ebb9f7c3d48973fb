#!/usr/bin/env bash
# The JAX package's MNIST across-dims sweep (the flags of
# scripts/bench_chain_r4e.sh:131-135) and the vMF runner's d 5 reference
# run (BASELINE.md:303-306: 60 epochs, full battery), both on the port,
# on one card.  The sweep runs as three slices by --d_dims side by side
# into ONE outdir (the per-trial sidecar merges per (d, family); the
# timing JSON merges and its total adds the slices' seconds); the vMF
# run beside them in an outdir of its own.  Where matplotlib is missing
# the drawing halves go through chip_smoke.py's pyplot recorder, so every
# curve of the battery is computed.
#
#   scripts/torch_sweep_mnist.sh OUTDIR
#
# Then hold the sweep against the JAX one:
#   python3 scripts/torch_compare_sweep.py \
#       OUTDIR/across_dims_mnist/mnist_vae_trial_metrics.json \
#       artifacts/across_dims_mnist/mnist_vae_trial_metrics.json \
#       --vmf OUTDIR/vmf artifacts/real_digits_vmf
set -eo pipefail
out=$(realpath -m "${1:?usage: $0 OUTDIR}")
root=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$out"
cd "$root"
export CLIFFORDTPU_DATA_DIR="$root/tests/data"
python3 -c "from cliffordtpu_torch.kernels import build; build.build_all()"
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
flags=(--n_runs 8 --epochs 60 --vmap_trials --eval_subprocess --no_wandb)
pids=()
for dims in "2 40" "5 20" "10"; do
  # shellcheck disable=SC2086
  python3 -m cliffordtpu_torch.scripts.mnist_clifpws --d_dims $dims \
    "${flags[@]}" --full_eval_runs 2 --require_real \
    --outdir "$out/across_dims_mnist" \
    > "$out/clifpws_d${dims// /_}.log" 2>&1 &
  pids+=($!)
done
python3 -m cliffordtpu_torch.scripts.mnist_vmf --d_dims 5 "${flags[@]}" \
  --outdir "$out/vmf" > "$out/vmf.log" 2>&1 &
pids+=($!)
rc=0
for p in "${pids[@]}"; do
  wait "$p" || rc=1
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader || true
exit $rc
