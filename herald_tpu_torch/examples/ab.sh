#!/bin/bash
# The A/B ladder of herald_tpu_torch (the counterpart of examples/ab.sh;
# reference examples/ctr/tests/run.sh): identical flags across the four
# modes the reference compares, each under torch.distributed.run with
# NPROC ranks (default 1, each on its own card; add --device cuda:0 to
# put every rank on card 0, or --device cpu):
#   baseline      (run_hetu analog: read every row every step)
#   assign-only   (affinity placement, no cache: isolates scheduling)
#   scheduled     (run_laia analog: lookahead planner + hot-row cache)
#   fae           (run_laia_fae analog: hot/cold split baseline)
# Each mode's output goes to ab_<mode>.log in the current directory.
#
#   [NPROC=S] bash herald_tpu_torch/examples/ab.sh [extra launch flags...]
set -e -o pipefail
root="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$root${PYTHONPATH:+:$PYTHONPATH}"
EX="$root/herald_tpu_torch/examples"
RUN="python -m torch.distributed.run --standalone --nproc-per-node ${NPROC:-1}"
BASE="--comm hybrid --nepoch 1 --batch-size 256 \
      --embedding-size 128 --cache-limit-ratio 0.1 $*"
FLAGS="--model wdl_criteo $BASE"
echo "== baseline (run_hetu analog) ==" | tee ab_baseline.log
$RUN "$EX/run_baseline.py" $FLAGS 2>&1 | tee -a ab_baseline.log
echo "== assign-only (scheduling without the cache) ==" | tee ab_assigned.log
$RUN -m herald_tpu_torch.launch --assign-only $FLAGS 2>&1 \
    | tee -a ab_assigned.log
echo "== scheduled (run_laia analog) ==" | tee ab_scheduled.log
$RUN "$EX/run_scheduled.py" $FLAGS 2>&1 | tee -a ab_scheduled.log
echo "== fae (run_laia_fae analog) ==" | tee ab_fae.log
$RUN "$EX/run_fae.py" --model fae_wdl_criteo --fae $BASE 2>&1 \
    | tee -a ab_fae.log
