"""Training loop: one epoch of teacher-forcing batches with AdamW.

Torch twin of navillm_tpu/training/train_loop.py's ``Metrics``,
``make_opt_step`` and ``train_one_epoch``: gradients accumulate in the
parameters' .grad (runner.zero_grads / take_grads), and every
gradient_accumulation_step batches one optimizer step applies clip +
AdamW. The loss of batch N is read on the host only after batch N+1 has
been dispatched (one-step lag), so the card works through N's backward
while the host simulates N+1. ``run_training`` (yaml config, validation,
checkpoints) is not ported yet.
"""
from __future__ import annotations


class Metrics:
    """Running averager (reference train.py:17-30)."""

    def __init__(self):
        self.num = 0
        self.total = 0.0

    def accumulate(self, x):
        self.num += 1
        self.total += float(x)

    @property
    def average(self):
        return self.total / self.num if self.num else 0.0


def make_opt_step(tx):
    """One optimizer update from a {name: gradient} dict; updates the
    parameters and moments in place (the JAX step donates them) and
    returns the pre-clip global gradient norm as a device scalar."""
    def opt_step(grads):
        return tx.step(grads)
    return opt_step


def train_one_epoch(args, cfg, runner, tx, opt_step, meta_loader, agents,
                    datasets, epoch, logger, num_batches):
    """Returns (average loss, pre-clip gradient norms of the optimizer
    steps as device scalars)."""
    stage_cfg = cfg.Pretrain if args.stage == "pretrain" else cfg.Multi
    loss_metric = Metrics()
    loss_stats = {k: Metrics() for k in stage_cfg.SOURCE}
    grad_norms = []

    runner.zero_grads()
    pending = None

    def drain(pending):
        if pending is not None:
            pname, ploss = pending
            ploss = float(ploss)
            loss_metric.accumulate(ploss)
            loss_stats[pname].accumulate(ploss)

    for step, (name, batch) in enumerate(meta_loader):
        agent = agents[name]
        loss = agent.train(name, batch, args, cfg, dataset=datasets.get(name),
                           step=step)
        drain(pending)
        pending = (name, loss)

        if (step + 1) % args.gradient_accumulation_step == 0:
            grad_norms.append(opt_step(runner.take_grads()))
            runner.zero_grads()

        if logger is not None and args.rank == 0 and (step + 1) % 100 == 0:
            logger.info("epoch %d step %d/%d [%s] loss=%.4f"
                        % (epoch, step + 1, num_batches, name,
                           loss_metric.average))

        if step == num_batches - 1:
            drain(pending)
            pending = None
            if logger is not None:
                msg = "***** train [%d] epoch *****\nLoss: %.4f\n" \
                    % (epoch, loss_metric.average)
                for task in stage_cfg.SOURCE:
                    msg += "%s: %.4f\n" % (task, loss_stats[task].average)
                logger.info(msg)
            break
    drain(pending)
    return loss_metric.average, grad_norms
