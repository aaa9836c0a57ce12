#!/usr/bin/env bash
# Full reproduction of the reference's thesis workflow on real corpora.
#
# Prereqs (the corpora are not redistributable; the reference gitignores
# them too):
#   data/                Google Speech Commands v0.02 extracted: data/<word>/*.wav
#   dataset/rodigits/    RoDigits corpus: dataset/rodigits/<speaker>/*.wav
#
# Mirrors: extract_features_construct_dataset.py -> train_google_dataset.py /
# train_constraints.py / train_no_constraints.py -> attacks.py, per task.
set -euo pipefail

CLI="python -m asr_using_robust_nn_tpu_torch"

# ---- Voice digit recognition ------------------------------------------------
$CLI prepare-data --task digit --data-dir data/ --out-dir processed_google_dataset/

$CLI train --config configs/digit_unconstrained.json \
    --data processed_google_dataset/ --ckpt runs/digit_unconstrained \
    --metrics-dir logs/digit_u
$CLI train --config configs/digit_constrained.json \
    --data processed_google_dataset/ --ckpt runs/digit_constrained \
    --metrics-dir logs/digit_c --monitor-lipschitz

# robustness curves (the thesis's attack matrix, attacks.py:2-12).
# --standardize after = the reference's 'A' branch: attacks run on RAW
# dB-scale MFCCs and standardization happens before prediction — the branch
# whose grids the defaults encode (mfcc sigmas 0-100, pgd/fgsm eps 1-30;
# attacks.py:320,497-499,648). '--standardize before' pairs with the
# 0.01-0.3 fgsm grid automatically but leaves the raw-unit mfcc/pgd grids
# saturated on unit-variance features.
for atk in white_mfcc mixture_mfcc white_audio mixture_audio snr_audio fgsm pgd jsma cw_l2 cw_linf; do
  $CLI attack --type "$atk" --task digit --data processed_google_dataset/ \
      --constrained runs/digit_constrained --unconstrained runs/digit_unconstrained \
      --standardize after --out "curves/digit_${atk}.json" --plot "curves/digit_${atk}.png"
done

# ---- Speaker recognition ----------------------------------------------------
$CLI prepare-data --task speaker --data-dir dataset/rodigits/ --out-dir RoDigits_splitV2/

$CLI train --config configs/speaker_unconstrained.json \
    --data RoDigits_splitV2/ --ckpt runs/speaker_unconstrained
$CLI train --config configs/speaker_constrained.json \
    --data RoDigits_splitV2/ --ckpt runs/speaker_constrained --monitor-lipschitz

for atk in white_mfcc mixture_mfcc white_audio mixture_audio snr_audio fgsm pgd; do
  $CLI attack --type "$atk" --task speaker --data RoDigits_splitV2/ \
      --constrained runs/speaker_constrained --unconstrained runs/speaker_unconstrained \
      --standardize after --out "curves/speaker_${atk}.json" --plot "curves/speaker_${atk}.png"
done

# ---- Dolphin (ultrasound) attack WAV ----------------------------------------
$CLI dolphin --voice "data/seven/0b40aa8e_nohash_0.wav" --out dolphin_attack.wav
