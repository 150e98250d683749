#!/bin/bash
# FairLoRA launcher for EVA02-CLIP-L/14-336 at its native 336 px: the hyperparameters of
# fairfedlora_fairfedmed.sh.  The EVA02 tower is a backbone of the PyTorch port
# (fairfedmed_tpu_torch) alone, so federated_main.py below runs as the port's CLI.
python() {
  if [ "$1" = federated_main.py ]; then shift; command python -m fairfedmed_tpu_torch.federated_main "$@"
  else command python "$@"; fi
}

DATA="DATA/"
MODEL=FedOTPLoRA
TRAINER=GLP_OT_SVLoRA
OT=None
TOP_PERCENT=0.8
EPS=0.1
THRESH=0.001
MAX_ITER=100
LR=0.001
GAMMA=0.1
USERS=3
FRAC=0.8
ROUND=50
STEPSIZE=200
NUM_PROMPT=2
CFG=eva02_l14_336_oph
NCTX=4
BETA=0.3
ATTRIBUTE_TYPE=${ATTRIBUTE_TYPE:-language}
LoRA_RANK=12
LoRA_ALPHA=2
SEED=${SEED:-1}
# client-parallel SPMD rounds (TPU path); PARALLEL_CLIENTS=0 for the
# sequential host loop
PARALLEL_FLAG=$([ "${PARALLEL_CLIENTS:-1}" = "1" ] && echo --parallel_clients)

DIR=output/FairLoRA_${CFG}_ema/fairfedmed_${ATTRIBUTE_TYPE}_rank${LoRA_RANK}_alpha${LoRA_ALPHA}/seed${SEED}
python federated_main.py \
  --root ${DATA} \
  --model ${MODEL} \
  --seed ${SEED} \
  --num_users ${USERS} \
  --frac ${FRAC} \
  --lr ${LR} \
  --OT ${OT} \
  --top_percent ${TOP_PERCENT} \
  --eps ${EPS} \
  --thresh ${THRESH} \
  --max_iter ${MAX_ITER} \
  --gamma ${GAMMA} \
  --trainer ${TRAINER} \
  --round ${ROUND} \
  --stepsize ${STEPSIZE} \
  --attribute_type ${ATTRIBUTE_TYPE} \
  --partition noniid-labeldir100 \
  --beta ${BETA} \
  --n_ctx ${NCTX} \
  --num_prompt ${NUM_PROMPT} \
  --unfreeze_image_encoder True \
  --lora_rank ${LoRA_RANK} \
  --lora_alpha ${LoRA_ALPHA} \
  --lora_type FairLoRA \
  --modality_type slo_fundus \
   \
  --dataset-config-file configs/datasets/fairfedmed.yaml \
  --config-file configs/trainers/GLP_OT/${CFG}.yaml \
  --output-dir ${DIR} \
  ${PARALLEL_FLAG} \
  --shared_half_s True \
  --lambda_fairness 0.0
