"""Each training and evaluation step as one CUDA graph replay.

Counterpart of the JAX package's jitted per-step entry points: there
``train_step``, ``eval_step``, ``fused_train_step``,
``fused_train_step_pipelined``, ``lazy_train_step`` and the sharded step's
train, gradient and eval programs each compile into one program with the
state donated, traced once per signature. Here each of them runs its eager
body (trainer.dense_step, trainer.eval_body, fused.fused_step,
fused.pipelined_step, lazy.lazy_step, ShardedTrainStep.step, .eval_body and
.grads_body), which reads its step scalars from a device row and updates
every state tensor in place, through a StepGraphs cache (``run``): on a
card a signature's first call runs the body eagerly, its second captures it
(utils/graphs.CapturedGraph: a warm-up on a copy of the state, or on the
model itself for an evaluation, which writes nothing; then the capture)
and replays it once, so that call too advances the state, and every later
call is one replay. Before each replay the call's inputs are copied into
the graph's static buffers: the batch columns, the [4] step row
(ops/fused_adam.scalar_rows: lr, bc1, bc2, step), the pipelined step's
gathered rows and, for a routed sharded step, its exchange plans; numpy
arrays through pinned memory, device tensors on the device. The outputs
come back as copies, so no caller holds a buffer the next replay
overwrites. The host's Adam count advances after each call, and a replay
adds the kernel launches counted at its capture to _kernels.launches.

The key (``run``) holds everything a graph reads in place: the kind of step
and its settings (optimizer, l2_reg_factor, merge, sorted_scatter,
kernel_gather; for a sharded step its process groups, routing, shard_anime,
capacity and exchange rounds), the state's tensors by address, shape,
strides and dtype (utils/graphs.layout: the moments' dtype with them), and
the inputs' names, shapes and dtypes. Not the learning rate, the Adam
count, the batch's values or the batch's addresses: one graph serves every
batch of an epoch (iter_batches pads the last batch to full size with
weight 0) and callers that cycle distinct device batches. A state restored
in place keeps its graph; a state whose tensors moved gets a new one.

The policy is ScanGraphs' (ops/scan_graph.py), under its lock: at most
``capacity`` graphs are kept, least recently used first out, and with each
its memory pool (90-415 MB at full width); ``StepGraphs(0)`` keeps none
and runs every call eagerly. The entry points share DEFAULT on a card; on
the CPU they take EAGER (``graphs_for``), the plain version the card holds
the replays against. ``release_graphs()`` frees DEFAULT's pools. A capture
that fails, or a body that reads a value on the host while it is captured,
raises: nothing falls back to the eager body on the card.
"""

from __future__ import annotations

import copy
import functools

import torch

from anime_recommendations_tpu_torch.models.two_tower import BUFFER_KEYS, PARAM_KEYS
from anime_recommendations_tpu_torch.ops.scan_graph import ScanGraphs
from anime_recommendations_tpu_torch.utils.graphs import layout

STEP_GRAPH_CACHE = 4   # step graphs a cache keeps, most recently used; each holds a pool


class StepGraphs(ScanGraphs):
    """The captured training and evaluation steps, by signature (module
    docstring); ScanGraphs' counters and report."""

    def __init__(self, capacity: int = STEP_GRAPH_CACHE):
        super().__init__(capacity)


DEFAULT = StepGraphs()
EAGER = StepGraphs(0)


def graphs_for(device) -> StepGraphs:
    """The cache the entry points take on ``device``: DEFAULT on a card,
    EAGER elsewhere."""
    return DEFAULT if torch.device(device).type == "cuda" else EAGER


def release_graphs() -> None:
    """Drop DEFAULT's step graphs and their memory pools."""
    DEFAULT.release()


def model_tensors(model) -> list[torch.Tensor]:
    """A model's parameters and BatchNorm buffers, in a fixed order."""
    return [getattr(model, k) for k in PARAM_KEYS + BUFFER_KEYS]


def state_tensors(state) -> list[torch.Tensor]:
    """A TrainState's tensors: the model's, then the Adam moments."""
    adam = state.adam
    return (model_tensors(state.model) + [adam.mu[k] for k in PARAM_KEYS]
            + [adam.nu[k] for k in PARAM_KEYS])


def copy_state(state):
    """A copy of a TrainState (its tensors cloned): what a warm-up writes."""
    return copy.deepcopy(state)


def signature(inputs: dict) -> tuple:
    """The names, shapes and dtypes of a call's inputs (tensors or numpy
    arrays; None for an input not given)."""
    return tuple((name, None) if v is None
                 else (name, tuple(v.shape), str(v.dtype).removeprefix("torch."))
                 for name, v in inputs.items())


def run(tag: tuple, body, state, inputs: dict, reads, device, writes: bool = True) -> tuple:
    """``body(state, **tensors)`` for ``inputs`` through the cache of
    ``device`` (graphs_for), keyed by ``tag`` (the step's kind and
    settings), the layout of ``reads`` (the state's tensors the body reads
    or writes in place) and the inputs' signature. A body that ``writes``
    warms up on copy_state(state) before a capture; one that writes nothing
    on ``state`` itself. Returns tensors the caller owns."""
    device = torch.device(device)
    key = (*tag, layout(reads), signature(inputs))
    warm_up = (lambda **t: body(copy_state(state), **t)) if writes else None
    return graphs_for(device).run(key, functools.partial(body, state), inputs, device, warm_up)
