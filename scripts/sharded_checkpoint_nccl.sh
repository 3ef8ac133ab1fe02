#!/bin/bash
# Sharded checkpoints over NCCL on four GPUs (the port's CLI, R8 doc-word,
# GCN on hybrid/allgather, seed 7): save the resumable state at epoch 10 on
# 4 ranks, resume it to epoch 20 on 4 ranks (compared bit for bit with an
# uninterrupted 20-epoch run) and on 2 ranks (the loss gap), and evaluate
# the saved params on one GPU with --load_model.
#
#   bash scripts/sharded_checkpoint_nccl.sh OUT_DIR
#
# Writes each run's log and results JSON under OUT_DIR (emptied first) and
# prints a summary.
O=${1:?usage: sharded_checkpoint_nccl.sh OUT_DIR}; rm -rf "$O"; mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/gpu.txt"
S="$O/checkpoints"; mkdir -p "$S"
F="--dataset R8 --graph docword --spmm hybrid --partition allgather --early_stopping 1000 --seeds 7"
run() { name=$1; shift; mkdir -p "$O/$name"; SECONDS=0
  timeout 400 python -m textgcn_tpu_torch.cli train $F --output_dir "$O/$name" "$@" > "$O/$name.log" 2>&1
  echo "$name rc=$? wall_s=$SECONDS"; tail -3 "$O/$name.log"; }
run save4 --shards 4 --max_epoch 10 --save_model "$S/m4" --save_state "$S/s4"
run full4 --shards 4 --max_epoch 20
run resume4 --shards 4 --max_epoch 20 --resume "$S/s4"
run resume2 --shards 2 --max_epoch 20 --resume "$S/s4"
run load1 --shards 4 --load_model "$S/m4"
python3 - "$O" <<'PY'
import json, sys
O = sys.argv[1]
r = {k: json.load(open(f"{O}/{k}/R8_docword_training_results.json"))
     for k in ("save4", "full4", "resume4", "resume2")}
tail = r["full4"]["runs"][0]["history"][10:]
for k in ("resume4", "resume2"):
    run = r[k]["runs"][0]
    h = run["history"][-len(tail):]
    same = sum(a["train_loss"] == b["train_loss"] and a["val_loss"] == b["val_loss"]
               for a, b in zip(h, tail))
    gap = max(abs(a["train_loss"] - b["train_loss"]) for a, b in zip(h, tail))
    print(k, "epochs", len(run["history"]), "bit-equal epochs", same, "of", len(tail),
          "max train-loss gap", gap, "acc", run["test"]["acc"], "sharding", r[k].get("sharding"),
          "resumed_from", r[k].get("resumed_from"))
print("full4 acc", r["full4"]["runs"][0]["test"]["acc"], "save4 acc",
      r["save4"]["runs"][0]["test"]["acc"], "checkpoint", r["save4"].get("checkpoint"),
      "state", r["save4"].get("resumable_checkpoint"))
for k, v in r.items():
    run = v["runs"][0]
    print(k, "ms/epoch", run["test"]["train_time"] * 1e3 / max(1, run["epochs_run"]))
PY
