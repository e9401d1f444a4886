"""Train and evaluate the Hollywood2 action classifier over record shards
on the card: the port's counterpart of the JAX package's
`cli/action_classification.py` (the reference's `Classifier.run` entry,
`models/action_classification.py:384-433,582-607`).

    python -m recurrent_gaze_prediction_tpu_torch.cli.action_classification \\
        --records_glob '/data/records/train-*.npz' --head NN --use_gazemap \\
        [--out scores.json] [--device cpu]

NN or SVM head, with or without the predicted gaze maps as attention,
over the shards of `cli.create_records`. Training batches come from an
endless sweep of the shards, reshuffled with the epoch as seed; then one
pass over `--eval_records_glob` (default: the training shards) gives the
Hamming loss, zero-one loss and mean average precision.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from typing import Optional

import numpy as np

from ..action import (ActionClassifier, ActionHParams, evaluate,
                      iter_record_batches)
from ..utils import log, resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--records_glob", required=True,
                        help="e.g. /path/records/train-*.npz")
    parser.add_argument("--eval_records_glob", default=None)
    parser.add_argument("--head", default="NN", choices=["NN", "SVM"])
    parser.add_argument("--use_gazemap", action="store_true",
                        help="use predicted gazemaps as attention")
    parser.add_argument("--batch_size", default=10, type=int)
    parser.add_argument("--max_iter", default=2001, type=int)
    parser.add_argument("--learning_rate", default=0.002, type=float)
    parser.add_argument("--reference_hinge", action="store_true",
                        help="SVM only: the reference's raw {0,1}-label "
                             "hinge verbatim, its absent-class zero "
                             "gradient included (action_classification.py:"
                             "250-254)")
    parser.add_argument("--out", default=None, help="write scores JSON here")
    parser.add_argument("--device", default="cuda",
                        help="torch device; the default needs a CUDA card")
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    train_paths = sorted(glob.glob(args.records_glob))
    if not train_paths:
        log.error("no record shards match %s", args.records_glob)
        return 1

    hp = ActionHParams(batch_size=args.batch_size, max_iter=args.max_iter,
                       learning_rate=args.learning_rate, head=args.head,
                       use_gazemap=args.use_gazemap,
                       svm_signed_labels=not args.reference_hinge)
    clf = ActionClassifier(hp, device=device)

    def endless_batches():
        epoch = 0
        while True:
            yield from iter_record_batches(train_paths, hp.batch_size,
                                           shuffle_seed=epoch)
            epoch += 1

    log.warn("training %s head (gaze attention: %s) ...", hp.head,
             hp.use_gazemap)
    losses = clf.fit(endless_batches())
    log.infov("final train loss: %.5f", losses[-1])

    eval_paths = (sorted(glob.glob(args.eval_records_glob))
                  if args.eval_records_glob else train_paths)
    y_true, y_score = [], []
    for batch in iter_record_batches(eval_paths, hp.batch_size,
                                     drop_remainder=True):
        y_true.append(batch["labels"])
        y_score.append(clf.predict(batch))
    scores = evaluate(np.concatenate(y_true), np.concatenate(y_score),
                      threshold=0.0 if hp.head == "SVM" else 0.5)
    for name in ("hamming_loss", "zero_one_loss", "mean_average_precision"):
        log.infov("%s: %.4f", name, scores[name])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in scores.items()}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
