"""What the systems share: the configuration's keys held to what the
system honours, the card's housekeeping and the training cells' epoch
loop around the port's `steps.make_train_epoch`."""

import torch

from .. import traffic as tr
from ..check import train_numbers
from ..reference.common import Adam, control_tf32, precision

TAG_DATA, TAG_ORDER, TAG_DROPOUT, TAG_TABLE, TAG_STATS = 1, 2, 3, 4, 5
# what a configuration file says about itself, not about the run
META_KEYS = frozenset({"system", "model", "source", "reduced", "assumed"})
# the dtypes the port's serving fns and train steps take as they are
# driven here (int8 serving needs the port's calibrated int8 fns)
DTYPES = ("float32", "bfloat16")


def honour(cfg, read, recorded):
    """Raise on a configuration key that the system neither ``read``s
    nor ``recorded`` (published keys that a window cannot change, such
    as the number of epochs), and on a dtype it does not run: a file
    that asks for something is run as it asks, or refused."""
    unknown = set(cfg) - META_KEYS - set(read) - set(recorded)
    if unknown:
        raise ValueError(f"configuration {cfg.get('model')!r}: keys "
                         f"{sorted(unknown)} are not honoured by system "
                         f"{cfg.get('system')!r}")
    if str(cfg.get("dtype", "float32")) not in DTYPES:
        raise ValueError(f"configuration {cfg.get('model')!r}: dtype "
                         f"{cfg['dtype']!r} is not run here: "
                         f"{' | '.join(DTYPES)}")


def dtypes(cfg):
    """(the compute dtype, the dtype the module is built in) that the
    port's `device` makes of the configuration's ``dtype``."""
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.device import \
        compute_dtype, module_dtype
    return compute_dtype(cfg["dtype"]), module_dtype(cfg["dtype"])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def fresh_peak(device):
    """Forget the inputs' temporaries: the peak from here on is the
    program's with its resident inputs."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def load(model, sd, device):
    """The port's module on ``device`` with the benchmark's state_dict
    (its own load_state_dict, strict)."""
    model = model.to(device)
    model.load_state_dict(sd, strict=True)
    return model


class EpochTrain:
    """A training cell's loop: the port's train epoch over resident
    (x, y), one seeded index table an epoch.  Subclasses build the model,
    the optimizer and ``epoch_fn`` (`steps.make_train_epoch`, with a
    `GraphCapture` on a card), keep the seed's state_dict on the host as
    ``sd0``, the learning rate as ``lr``, and write ``ref_loss``.

    The set-up epoch is the first epoch of the same object, watched:
    Adam's first moment after step 1 (the gradient it got, times 1 -
    beta1) and the weights after step 3, before step 4 moves them.
    Every epoch's losses, the set-up's and the window's, are counted on
    the card, and a loss that is not finite makes the run incorrect."""

    def start(self, seed, device):
        self.seed, self.device = seed, device
        self.names = [n for n, _ in self.model.named_parameters()]
        self.tables = tr.generator(seed, TAG_TABLE, device)
        seen = {"n": 0}
        params = list(self.model.parameters())
        b1 = self.opt.param_groups[0]["betas"][0]

        def watch():
            seen["n"] += 1
            with torch.no_grad():
                if seen["n"] == 1:
                    self.grad1 = [self.opt.state[p]["exp_avg"] / (1 - b1)
                                  for p in params]
                elif seen["n"] == 3:
                    self.after3 = [p.detach().clone() for p in params]

        self.nonfinite = torch.zeros((), dtype=torch.int64, device=device)
        self.n_losses = 0
        self.table0 = tr.epoch_table(len(self.x), self.bs, self.tables)
        losses = self.epoch_fn(self.x, self.y, self.table0, on_batch=watch)[0]
        self.losses3 = losses[:3].clone()
        self._count(losses)
        sync(device)

    def _count(self, losses):
        """Add an epoch's losses to the count of those not finite, on
        the card (no sync)."""
        self.nonfinite += (~torch.isfinite(losses)).sum()
        self.n_losses += len(losses)

    def epoch(self, spans):
        """One whole epoch; returns its steps, all ended."""
        table = tr.epoch_table(len(self.x), self.bs, self.tables)
        with spans("epoch"):
            self._count(self.epoch_fn(self.x, self.y, table)[0])
            sync(self.device)
        return table.shape[0]

    def release(self):
        self.grad1 = [t.cpu() for t in self.grad1]
        self.after3 = [t.cpu() for t in self.after3]
        self.losses3 = [float(v) for v in self.losses3.cpu()]
        self.nonfinite = int(self.nonfinite)
        self.model = self.opt = self.epoch_fn = None

    def ref_loss(self, params, idx, generator):
        """The plain reference's loss of the rows ``idx`` under
        ``params`` (the reference's keys), dropout drawn from
        ``generator``."""
        raise NotImplementedError

    def reference_steps(self, tf32=False, rows=None):
        """(three losses, the first gradient, the weights after three
        steps), leaves in ``self.names``' order: the plain reference from
        the seed's weights on the set-up epoch's first three batches,
        dropout from a generator of the same seed as the program's;
        ``rows`` keeps only a batch's first rows (a fault)."""
        dev = self.device
        sd = {k: v.to(dev) for k, v in self.sd0.items()}
        leaves = [sd[n].clone().requires_grad_(True) for n in self.names]
        adam = Adam(leaves, self.lr)
        gen = tr.generator(self.seed, TAG_DROPOUT, dev)
        losses, grad1 = [], None
        with precision(tf32=tf32):
            for s in range(3):
                params = {**sd, **dict(zip(self.names, leaves))}
                loss = self.ref_loss(params, self.table0[s][:rows], gen)
                grads = torch.autograd.grad(loss, leaves)
                if grad1 is None:
                    grad1 = [g.detach() for g in grads]
                adam.step(grads)
                losses.append(float(loss.detach()))
        return losses, grad1, [p.detach() for p in leaves]

    def check(self):
        losses, grad1, after = self.reference_steps()
        start = [self.sd0[n] for n in self.names]
        numbers = train_numbers(
            self.losses3, self.grad1,
            [a - s for a, s in zip(self.after3, start)],
            losses, [g.cpu() for g in grad1],
            [a.cpu() - s for a, s in zip(after, start)])
        numbers["nonfinite_loss"] = self.nonfinite
        numbers["losses"] = self.n_losses
        return numbers

    def control(self, fault=None):
        """The control's numbers: three reference steps in TF32 put in
        the program's place, compared as the program's are.  With
        ``fault="half"`` the f32 reference on the first half of each
        batch's rows (the mean over them) is put there instead."""
        if fault == "half":
            losses, grad1, after = self.reference_steps(rows=self.bs // 2)
        else:
            losses, grad1, after = self.reference_steps(
                tf32=control_tf32(self.cfg))
        self.losses3 = losses
        self.grad1 = [g.cpu() for g in grad1]
        self.after3 = [a.cpu() for a in after]
        return self.check()
