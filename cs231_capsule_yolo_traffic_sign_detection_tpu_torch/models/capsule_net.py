"""CapsuleNet — capsule classifier with dynamic routing (PyTorch port).

Counterpart of the JAX models/capsule_net.py: a 9x9 conv to 256
channels (32 -> 24 px), relu, primary capsules (eight 8x8 stride-2 convs
of 16 channels: 8-d vectors over 16 x 9 x 9 = 1296 nodes), routing to
n_classes capsules of 16 dims, class scores = capsule lengths, and the
reconstruction decoder, fed the true class's capsule in training.  The
forward takes NHWC crops, as the JAX module does.  Initial weights come
from ``seed`` alone (models/init.py).

The state_dict is the reference's: ``conv1.*``,
``primary_capsules.capsules.{0..7}.*``,
``traffic_sign_capsules.route_weights`` (1, 1296, n_classes, 8, 16) and
``decoder.{0,4,7,10,12}.*``.  Nodes are in the reference's order,
(channel c, position p) at c * 81 + p; the JAX package uses (p, c) and
permutes the route weights on the way across (interop.py).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.capsule import (capsule_norm, compute_priors, dynamic_routing,
                           node_sharded_routing, routed_single_capsule)
from ..ops.primary_caps import (prepare_weights, primary_caps,
                                primary_caps_plain, takes as takes_k5)
from ..parallel.collectives import NodeShard
from ..ops.routing import routed_capsules
from .init import init_capsulenet
from .layers import ReconDecoder


class PrimaryCapsules(nn.Module):
    """Conv -> capsules: (B, 256, H, W) -> squashed (B, 16*h*w, 8).  An
    f32 call that needs no gradient at CapsuleNet's geometry
    (`ops.primary_caps.takes`) runs K5, ``torch.ops.cyt.primary_caps``
    (the CUDA kernel on a card, the plain version on the CPU), on the
    weights laid out for it once per version; every other call
    (training, bf16, f64, other geometries) the plain composition."""

    def __init__(self, in_channels=256, n_caps=8, out_c=16, kernel=8,
                 stride=2):
        super().__init__()
        self.stride = stride
        self.capsules = nn.ModuleList(
            nn.Conv2d(in_channels, out_c, kernel, stride)
            for _ in range(n_caps))
        self._k5_key, self._k5_w = None, None

    def forward(self, x, dtype=torch.float32):
        if takes_k5(self.capsules, x, dtype):
            wp, b = self._k5_weights()
            if x.is_cuda:  # no copy: cuDNN leaves conv1's map channels-last
                x = x.contiguous(memory_format=torch.channels_last)
            return primary_caps(x, wp, b)
        w, b = self._stacked()
        return primary_caps_plain(x, w, b, len(self.capsules), self.stride,
                                  dtype)

    def _stacked(self):
        """The eight convs as one: output channel j*16 + c is conv j's c."""
        return (torch.cat([m.weight for m in self.capsules]),
                torch.cat([m.bias for m in self.capsules]))

    def _k5_weights(self):
        """The stacked weights as K5 reads them (`prepare_weights`) and
        the stacked bias, kept until a parameter changes (in place, or
        moved).  Under torch.export they are part of the traced program,
        and under a CUDA graph's capture they are recorded in the graph
        and not kept: a replay reads the weights as they are then (the
        train graph's Adam moves them without a version bump:
        `drop_k5_copy`)."""
        params = [p for m in self.capsules for p in (m.weight, m.bias)]

        def make():
            w, b = self._stacked()
            return prepare_weights(w), b

        if torch.compiler.is_exporting() or (
                params[0].is_cuda
                and torch.cuda.is_current_stream_capturing()):
            return make()
        key = tuple((p.data_ptr(), p._version) for p in params) + (
            params[0].device,)
        if key != self._k5_key:
            with torch.no_grad():
                self._k5_w = make()
            self._k5_key = key
        return self._k5_w

    def drop_k5_copy(self):
        """Forget K5's copy of the weights: they changed where their
        version counters do not see it (a CUDA graph's replay)."""
        self._k5_key, self._k5_w = None, None


class CapsuleRouting(nn.Module):
    """Capsules -> capsules by dynamic routing: (B, N, in_c) ->
    (B, n_caps, out_c).  ``impl`` is the resolved ``--routing``
    (models/registry.py): "pallas" takes the fused kernels K3 and, in
    training, K4 (ops/routing.py) on a CUDA tensor and their plain
    versions on a CPU tensor; "xla" the plain composition of
    ops/capsule.py (votes, then `dynamic_routing`) in f32 on any device,
    differentiated by autograd.  One output capsule takes the closed
    form whatever ``impl``.  The route weights start at zero:
    CapsuleNet draws them from its seed (models/init.py).  Under a
    mesh's model axis `shard_nodes` keeps this rank's nodes only, and the
    forward runs `ops.capsule.node_sharded_routing`."""

    def __init__(self, n_caps, n_nodes, in_c, out_c, n_iter=3,
                 impl="pallas"):
        super().__init__()
        if impl not in ("pallas", "xla"):
            raise ValueError(f"routing impl {impl!r}: pallas | xla")
        self.n_iter, self.impl = n_iter, impl
        self.route_weights = nn.Parameter(
            torch.zeros(1, n_nodes, n_caps, in_c, out_c))
        self._bf16_key, self._bf16_w = None, None
        self.node_shard = None

    def shard_nodes(self, group, rank, n_shards):
        """Keep nodes [rank * N / n_shards, (rank + 1) * N / n_shards) of
        the route weights (a new, smaller parameter) and route over the
        node split of ``group`` from now on; the plain routing only (the
        fused kernel takes every node)."""
        n = self.route_weights.shape[1]
        if n % n_shards:
            raise ValueError(f"{n} routing nodes do not split over "
                             f"{n_shards} model ranks")
        per = n // n_shards
        self.node_shard = NodeShard(group, rank * per, (rank + 1) * per)
        self.impl = "xla"
        self.route_weights = nn.Parameter(
            self.route_weights.detach()[:, rank * per:(rank + 1) * per]
            .clone())

    def forward(self, x, bf16=False):
        w = self.route_weights[0]
        if self.node_shard is not None:  # f32 whatever bf16, as "xla"
            return node_sharded_routing(x, w, self.node_shard, self.n_iter)
        if w.shape[1] == 1:
            return routed_single_capsule(x, w)
        if self.impl == "xla":  # f32 whatever bf16, as the JAX module
            return dynamic_routing(compute_priors(x, w),
                                   n_iter=self.n_iter)[:, 0]
        return routed_capsules(x, self._routed_weights(w, bf16), self.n_iter,
                               bf16=bf16)

    def _routed_weights(self, w, bf16):
        """The route weights as K3 reads them.  bf16 serving (no gradient)
        reuses one bf16 copy, made again when the parameter changes (in
        place, or moved); with a gradient `RoutedCapsules` casts inside
        the op, so the gradient reaches the f32 weights.  Under
        torch.export the cast is part of the traced program (a traced
        parameter has no storage to key a copy on), and under a CUDA
        graph's capture it is recorded in the graph and not kept: a
        replay reads the weights as they are then (the train graph's Adam
        moves them without a version bump: `drop_bf16_copy`)."""
        if not bf16 or (torch.is_grad_enabled() and w.requires_grad):
            return w
        if torch.compiler.is_exporting() or (
                w.is_cuda and torch.cuda.is_current_stream_capturing()):
            return w.to(torch.bfloat16)
        p = self.route_weights
        key = (p.data_ptr(), p._version, p.device)
        if key != self._bf16_key:
            with torch.no_grad():
                self._bf16_w = w.to(torch.bfloat16)
            self._bf16_key = key
        return self._bf16_w

    def drop_bf16_copy(self):
        """Forget the bf16 copy: the weights changed where their version
        counter does not see it (a CUDA graph's replay)."""
        self._bf16_key, self._bf16_w = None, None


class CapsuleNet(nn.Module):
    """``dtype`` is the compute dtype of the convs and the decoder:
    bfloat16 runs them in bf16 and K3/K4 in their bf16 mode; squash and
    routing state stay f32, and the parameters stay f32 (the master
    copy) whatever the dtype.  ``routing_impl`` ("pallas" | "xla", the
    resolved ``--routing``) picks the routing (`CapsuleRouting`)."""

    def __init__(self, n_classes=43, dtype=torch.float32, seed=0,
                 routing_impl="pallas"):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 256, 9)
        self.primary_capsules = PrimaryCapsules()
        self.traffic_sign_capsules = CapsuleRouting(
            n_caps=n_classes, n_nodes=16 * 9 * 9, in_c=8, out_c=16,
            impl=routing_impl)
        self.decoder = ReconDecoder()
        init_capsulenet(self, seed)

    def capsules(self, x):
        """NHWC crops (B, 32, 32, 3) -> class capsules (B, n_classes, 16)."""
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        x = F.relu(F.conv2d(x, self.conv1.weight.to(dt),
                            self.conv1.bias.to(dt)))
        x = self.primary_capsules(x, dt)
        return self.traffic_sign_capsules(x, bf16=dt == torch.bfloat16)

    def forward(self, x, y=None, recon=False):
        """Class scores (B, n_classes) f32: the capsules' lengths; with
        ``recon``, also the crops (B, 32, 32, 3) f32 decoded from the
        capsule of each crop's true class ``y`` (B,)."""
        caps = self.capsules(x)
        scores = capsule_norm(caps)
        if not recon:
            return scores
        t = caps[torch.arange(caps.shape[0], device=caps.device), y]
        return scores, self.decoder(t, self.dtype)
