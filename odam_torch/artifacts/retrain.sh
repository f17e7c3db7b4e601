#!/bin/bash
# Recreate the hard-rehearsal weights with the port's trainer
# (counterpart of artifacts/retrain.sh; artifacts/README.md has the recipe).
# The detector trains in crash-isolated 1500-step segments (the trainer's
# seg*steps cosine-schedule offset): an interrupted segment is re-run from
# the last completed boundary.
#
# Usage: odam_torch/artifacts/retrain.sh [--device cpu] [--out DIR] [first_segment]
#   --out: the output root (default runs/retrain), which receives
#   rehearsal_hard_assoc_ckpt/ and rehearsal_hard_detr_ckpt/, checkpoint
#   directories of the port.  It never writes into artifacts/, so the
#   committed weights cannot be overwritten.
#   No first_segment: derives the next segment from the detector
#   checkpoint's own meta (the trainer re-verifies it on resume).  An
#   existing checkpoint without a global_step in its meta requires an
#   explicit segment: a silent default of 0 would double-train it.
#   The trainer runs on the card unless --device cpu.
set -x
cd "$(dirname "$0")/../.." || exit 1
OUT=runs/retrain
DEVICE=cuda
FIRST=
while [ $# -gt 0 ]; do
  case "$1" in
    --device) DEVICE="$2"; shift 2 ;;
    --out) OUT="$2"; shift 2 ;;
    *) FIRST="$1"; shift ;;
  esac
done
case "$(realpath -m "$OUT")/" in
  "$(realpath -m artifacts)"/*) echo "refusing to write under artifacts/: $OUT" >&2; exit 1 ;;
esac
export ODAM_HARD=1 PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
ASSOC="$OUT/rehearsal_hard_assoc_ckpt"
DETR="$OUT/rehearsal_hard_detr_ckpt"
if [ ! -d "$ASSOC" ]; then
  python -m odam_torch.examples.cli_rehearsal.train associator 0 800 "$ASSOC" --device "$DEVICE" \
    || exit 1
fi
if [ -z "$FIRST" ]; then
  if [ -d "$DETR" ]; then
    FIRST=$(python - "$DETR" <<'EOF'
import sys
from odam_torch.utils import checkpoint
meta = checkpoint.load_meta(sys.argv[1])
if meta is None or "global_step" not in meta:
    raise SystemExit(
        "rehearsal_hard_detr_ckpt exists but has no global_step meta; "
        "pass the next segment explicitly (see artifacts/TRAINLOG.md)")
print(int(meta["global_step"]) // int(meta.get("seg_steps", 1500)))
EOF
    ) || exit 1
  else
    FIRST=0
  fi
fi
for s in $(seq "$FIRST" 11); do
  ODAM_LR=6e-4 ODAM_DECAY_STEPS=18000 ODAM_BANK=150 \
    python -m odam_torch.examples.cli_rehearsal.train detector "$s" 1500 "$DETR" --device "$DEVICE" \
    || exit 1
  echo "SEGMENT $s DONE $(date -u +%FT%TZ)"
done
