"""Train and eval steps (counterpart of the JAX train/steps.py).

`train_step` is one forward (with the reconstruction for the capsule
classifier, with dropout from the trainer's generator for the darknet
detectors and the cnn classifier), the model's loss from `LOSS_REGISTRY`, the
backward (K4 on a card for the capsule classifier) and one Adam update.  optax's
``scale_by_adam`` with ``-lr`` applied, as the JAX step does it, is
torch's Adam with betas (0.9, 0.999) and eps 1e-8.  The learning rate
is set on the optimizer before each step, from the plateau schedule.
Master parameters and Adam moments stay f32 whatever the compute dtype.
Frozen parameters (``requires_grad=False``, fine-tuning) stay out of
Adam, as in the reference.  The loss, the outputs and the loss's aux
(``avg_iou`` for the darknet detectors) come back as tensors on the
device: nothing here syncs the host with the card.  On a card Adam is
``capturable`` with its learning rate a 0-d tensor on the device, which
`set_lr` fills: the step count and the bias corrections stay on the
device, so a step can be captured in a CUDA graph, and the eager loop
runs the same arithmetic as the captured epoch.  Checkpoints hold the
optimizer in the reference's format (`optimizer_state`, a float lr and
host step counts), which `load_optimizer_state` reads back on either
device.

`make_train_epoch` and `make_eval_epoch` (``--scan_epoch``; JAX
train/steps.py:188-264) run one group of equal-size batches of an
epoch: each batch is gathered on the device by a row of an index table
and runs `train_step` or `eval_step`, its outputs written into per-batch
slots.  On a card the batch's work is captured once as a CUDA graph
(`GraphCapture`) and replayed per batch; on the CPU the same body runs
eagerly.

Under a mesh (parallel/) a step runs one data rank's rows: ``shard`` (a
`parallel.collectives.BatchShard`) makes BatchNorm and dropout the
global batch's, and after the backward the gradients are averaged over
``grad_group`` (the data group) in one all-reduce, the node-sharded
route weights' too.  Every loss divides by its local batch, so equal
shards give the global mean.
"""

import torch

from .. import profiling
from ..losses import capsule_loss, cnn_loss, dark_loss, darkcapsule_loss
from ..ops import input_stage, pool, routing
from ..parallel.collectives import all_reduce_grads

LOSS_REGISTRY = {"cnn": cnn_loss, "capsule": capsule_loss,
                 "darknet_d": dark_loss, "darknet_r": dark_loss,
                 "darkcapsule": darkcapsule_loss}


# the kernels' wrappers: ``.launches`` counts each one's launches
COUNTED = (pool.maxpool2_leaky, input_stage.input_stage,
           routing.routed_capsules, routing.routed_capsules_backward)


def make_optimizer(model, lr=1e-3):
    """Adam with torch defaults (the reference's, main.py:280) over the
    parameters that train; on a card capturable, its lr a 0-d tensor."""
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    _to_device_adam(opt)
    return opt


def _to_device_adam(opt):
    """On a card: Adam made capturable, its lr a 0-d f32 tensor and its
    step counts f32 tensors on the parameters' device."""
    params = [p for g in opt.param_groups for p in g["params"]]
    if not params or params[0].device.type != "cuda":
        return
    for group in opt.param_groups:
        group["capturable"] = True
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = torch.tensor(float(group["lr"]),
                                       device=params[0].device)
    for p, st in opt.state.items():
        if "step" in st:
            st["step"] = st["step"].to(p.device, torch.float32)


def set_lr(opt, lr):
    """The learning rate of every group: filled into the device tensor of
    a card's Adam (a captured step reads it), set as a float otherwise."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def optimizer_state(opt):
    """``opt.state_dict()`` in the reference's format whatever the
    device: each group's lr a float, not capturable, each step count a
    0-d f32 tensor on the host (one copy from the card for all)."""
    sd = opt.state_dict()
    groups = [dict(g, lr=float(g["lr"]), capturable=False)
              for g in sd["param_groups"]]
    state = dict(sd["state"])
    on_card = [i for i, st in state.items()
               if isinstance(st.get("step"), torch.Tensor)
               and st["step"].device.type != "cpu"]
    if on_card:
        host = torch.stack([state[i]["step"] for i in on_card]).cpu()
        for i, step in zip(on_card, host.unbind(0)):
            state[i] = dict(state[i], step=step.clone())
    return dict(sd, state=state, param_groups=groups)


def load_optimizer_state(opt, sd):
    """``opt.load_state_dict(sd)``, then on a card Adam capturable again
    (a new lr tensor: drop any CUDA graph that read the old one)."""
    opt.load_state_dict(sd)
    _to_device_adam(opt)


def loss_and_scores(model, x, y, loss_cfg, model_name, generator=None,
                    shard=None):
    """Forward (with the reconstruction when the loss wants it; dropout
    masks from ``generator``; BN and dropout over the global batch of
    ``shard``) and the model's loss; returns (loss, outputs, aux)."""
    loss_fn = LOSS_REGISTRY[model_name]
    if model_name == "capsule" and loss_cfg.recon:
        scores, recon = model(x, y, recon=True)
        loss, aux = loss_fn(scores, y, loss_cfg, x, recon)
    else:
        kw = {} if generator is None else {"generator": generator}
        if shard is not None:
            kw["shard"] = shard
        scores = model(x, **kw)
        loss, aux = loss_fn(scores, y, loss_cfg)
    return loss, scores, aux


def train_step(model, opt, x, y, lr, loss_cfg, model_name, generator=None,
               shard=None, grad_group=None):
    """One Adam step on the batch (x NHWC, y labels or grids) at ``lr``
    (None: the optimizer's as it is); returns the loss (a 0-d tensor) and
    the outputs, detached, and the aux (no gradient flows into it), on
    x's device.  Under a mesh: ``shard`` for BN and dropout, and the
    gradients averaged over ``grad_group`` before the update (a
    replicated batch passes neither: every rank already holds the whole
    batch's gradient)."""
    if lr is not None:
        set_lr(opt, lr)
    opt.zero_grad(set_to_none=True)
    loss, scores, aux = loss_and_scores(model, x, y, loss_cfg, model_name,
                                        generator, shard)
    loss.backward()
    if grad_group is not None:
        all_reduce_grads(model.parameters(), grad_group)
    opt.step()
    return loss.detach(), scores.detach(), aux


def eval_step(model, x, y, loss_cfg, model_name):
    """Loss, outputs and aux on the batch, with the reconstruction as in
    training (the JAX eval does the same), no gradient."""
    with torch.no_grad():
        return loss_and_scores(model, x, y, loss_cfg, model_name)


class GraphCapture:
    """What the CUDA graphs of one Trainer share: a side stream on which
    each graph's first batch runs eagerly (the warm-up of PyTorch's
    whole-network capture recipe: cuBLAS and cuDNN workspaces, Adam's
    state and the kernels' launch plans are made there, outside any
    capture) and on which it is captured, one memory pool, and the
    generators every graph registers (without registration every replay
    would draw the masks of the capture).  ``seconds``: the host time its
    captures took, the sum of their ``cyt.setup.capture`` spans."""

    def __init__(self, device, generators=()):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.generators = [g for g in generators if g is not None]
        self.seconds = 0.0

    def warm_up(self, fn):
        """``fn()`` eagerly on the side stream."""
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            fn()
        torch.cuda.current_stream().wait_stream(self.stream)

    def capture(self, fn):
        """``fn``'s work as a CUDA graph; returns (graph, launches): each
        counted kernel's launches in one replay.  The capture launched
        nothing, so the counts it added are taken back."""
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = [w.launches for w in COUNTED]
        with profiling.span(profiling.SETUP_CAPTURE) as span:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                fn()
        self.seconds += span.seconds
        launches = []
        for w, n in zip(COUNTED, before):
            launches.append((w, w.launches - n))
            w.launches = n
        return graph, launches


class Epoch:
    """One group of equal-size batches of an epoch (``--scan_epoch``):
    ``epoch(x, y, table, lr)`` runs a batch for each row of ``table``
    (n_batch, bs) int64 on the device, gathered from the resident
    ``x``/``y``, and returns the per-batch slots (losses (n_batch,), aux
    {key: (n_batch,)}, outputs (n_batch, bs, ...)), valid until its next
    call.  A batch is ``step(xb, yb) -> (loss, outputs, aux)`` between
    ``idx = table[ctr]`` and the copies into slot ``ctr``, then ``ctr +=
    1``, all on the device.  With ``capture`` (a `GraphCapture`, on a
    card) the first call runs its first batch eagerly, captures the
    batch and replays the graph for the others; later calls replay every
    batch, after refilling the table and the counter.  Without it (the
    CPU) every batch runs eagerly: the plain version of the graph.  The
    kernels' launch counts grow by the capture's count at each replay.
    The first call's first batch (and the capture) is a
    ``cyt.setup.first_call`` span (`profiling`)."""

    def __init__(self, step, opt=None, capture=None):
        self.step, self.opt, self.capture = step, opt, capture
        self.graph, self.launches = None, ()
        self._table = self._ctr = self._inputs = self.slots = None

    def _body(self):
        x, y = self._inputs
        idx = self._table.index_select(0, self._ctr).squeeze(0)
        loss, out, aux = self.step(x.index_select(0, idx),
                                   y.index_select(0, idx))
        with torch.no_grad():
            if self.slots is None:
                n = self._table.shape[0]
                self.slots = (loss.new_empty((n,)),
                              {k: v.new_empty((n,)) for k, v in aux.items()},
                              out.new_empty((n,) + tuple(out.shape)))
            losses, auxes, outs = self.slots
            losses.index_copy_(0, self._ctr, loss[None])
            for k, v in aux.items():
                auxes[k].index_copy_(0, self._ctr, v[None])
            outs.index_copy_(0, self._ctr, out[None])
            self._ctr.add_(1)

    def _replay(self):
        self.graph.replay()
        for w, k in self.launches:
            w.launches += k

    def __call__(self, x, y, table, lr=None, on_batch=None):
        if self._inputs is not None and (
                self._inputs[0] is not x or self._inputs[1] is not y
                or self._table.shape != table.shape):
            raise ValueError("Epoch: called on other data than its graph "
                             "reads; make a new one")
        if self._table is None:
            self._inputs = (x, y)
            self._table = torch.empty_like(table)
            self._ctr = torch.zeros(1, dtype=torch.int64, device=x.device)
        self._table.copy_(table)
        self._ctr.zero_()
        if lr is not None:
            set_lr(self.opt, lr)
        done = 0
        if self.slots is None and table.shape[0]:
            with profiling.span(profiling.SETUP_FIRST_CALL):
                if self.capture is None:
                    self._body()
                else:
                    self.capture.warm_up(self._body)
                if on_batch is not None:
                    on_batch()
                if self.capture is not None:
                    self.graph, self.launches = self.capture.capture(
                        self._body)
            done = 1
        batch = self._body if self.capture is None else self._replay
        for _ in range(done, table.shape[0]):
            batch()
            if on_batch is not None:
                on_batch()
        return self.slots


def make_train_epoch(model, opt, loss_cfg, model_name, generator=None,
                     shard=None, grad_group=None, aux_fn=None, capture=None):
    """The train `Epoch` of a group (JAX make_train_epoch): each batch
    is `train_step` (``shard`` and ``grad_group`` as there, the lr the
    optimizer's, which the call sets); ``aux_fn(aux, yb)`` adds to a
    step's aux (the mesh's object count)."""

    def step(xb, yb):
        loss, out, aux = train_step(model, opt, xb, yb, None, loss_cfg,
                                    model_name, generator, shard,
                                    grad_group)
        return loss, out, aux if aux_fn is None else aux_fn(aux, yb)

    return Epoch(step, opt, capture)


def make_eval_epoch(model, loss_cfg, model_name, aux_fn=None, capture=None):
    """The eval `Epoch` of a group (JAX make_eval_epoch): each batch is
    `eval_step`."""

    def step(xb, yb):
        loss, out, aux = eval_step(model, xb, yb, loss_cfg, model_name)
        return loss, out, aux if aux_fn is None else aux_fn(aux, yb)

    return Epoch(step, None, capture)
