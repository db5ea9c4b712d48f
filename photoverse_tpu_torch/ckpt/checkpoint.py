"""Checkpoints: the trainable / frozen split of the model bundle, saving and
resuming, in both of the JAX package's formats. Port of
photoverse_tpu/ckpt/checkpoint.py.

Trainable: both adapters, and in the UNet the identity projections
(`to_k_ip`, `to_v_ip`) and the LoRA factors (`lora_A`, `lora_B`); every other
parameter is frozen. Keys are "<model>.<parameter name>", so the first
component names the clipping group: text_adapter / image_adapter / unet.

Formats:
  - native `.msgpack` (`save_progress` / `load_progress`): the JAX package's
    layout, written by the port's own MessagePack codec (ckpt/msgpack_codec):
    {"trainable": {"/"-joined JAX path: array}, "step": int,
    "optimizer": the optax state as flax's `to_state_dict` lays it out}.
    The trainables go through convert/to_jax; the optimizer through
    `optax_state` / `load_optax_state` (AdamW's exp_avg / exp_avg_sq / step
    are optax's mu / nu / count, the accumulation window is MultiSteps'
    acc_grads / mini_step / gradient_step). A `.lora.json` sidecar carries
    the LoRA config; it lands before the checkpoint, and both writes are
    atomic (`.tmp` + os.replace).
  - reference `.pt` (`save_progress_pt` / `load_photoverse_checkpoint`):
    {image_adapter, text_adapter, cross_attention_adapter, lora_config?}.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from photoverse_tpu_torch.ckpt import msgpack_codec
from photoverse_tpu_torch.convert import to_jax

__all__ = [
    "partition_params",
    "combine_params",
    "TRAINABLE_UNET_LEAVES",
    "snapshot_keys",
    "host_save_snapshot",
    "optax_state",
    "load_optax_state",
    "save_progress",
    "save_progress_pt",
    "load_progress",
    "peek_lora_config",
    "load_photoverse_checkpoint",
    "AsyncCheckpointer",
]

TRAINABLE_UNET_LEAVES = ("to_k_ip", "to_v_ip", "lora_A", "lora_B")


def partition_params(models) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """-> (trainable, frozen), each {"<model>.<name>": Parameter}."""
    trainable: Dict[str, nn.Parameter] = {}
    frozen: Dict[str, nn.Parameter] = {}
    for model in ("text_adapter", "image_adapter", "text_encoder", "vision_encoder", "vae", "unet"):
        for name, p in getattr(models, model).named_parameters():
            if model.endswith("adapter") or (
                model == "unet" and any(part in TRAINABLE_UNET_LEAVES for part in name.split("."))
            ):
                trainable[f"{model}.{name}"] = p
            else:
                frozen[f"{model}.{name}"] = p
    return trainable, frozen


def combine_params(trainable: Dict, frozen: Dict) -> Dict:
    """The two partitions as one {name: parameter} dict (the models hold
    both in place, so this is the whole parameter set by name)."""
    return {**trainable, **frozen}


def _host(t: torch.Tensor) -> np.ndarray:
    # always a copy: a CPU parameter's .numpy() would share its memory, and
    # an async write would then serialise what later steps made of it
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def snapshot_keys(models) -> list:
    """The parameters a checkpoint snapshot holds: the trainable set plus
    the frozen attn2 parameters of the UNet."""
    trainable, frozen = partition_params(models)
    return list(trainable) + [k for k in frozen if k.startswith("unet.") and ".attn2." in k]


def host_save_snapshot(models, layout=None) -> Optional[Dict[str, np.ndarray]]:
    """Host f32 copy of what `save_progress` and `save_progress_pt` write:
    the trainable set plus the frozen attn2 parameters of the UNet (the
    `.pt` exports the base q/k/v beside the LoRA factors). The rest of the
    frozen backbone stays on the device. With a multi-rank `layout`
    (parallel.training.TrainLayout) every rank takes part in gathering the
    shards and rank 0 receives the whole leaves (the others None)."""
    if layout is not None:
        return layout.host_snapshot(models, snapshot_keys(models))
    trainable, frozen = partition_params(models)
    params = {**trainable, **frozen}
    return {k: _host(params[k]) for k in snapshot_keys(models)}


def _trainable_names(snapshot: Dict) -> list:
    return [k for k in snapshot if k.split(".", 1)[0] in ("text_adapter", "image_adapter")
            or any(part in TRAINABLE_UNET_LEAVES for part in k.split("."))]


# ---------------------------------------------------------------------------
# the optimizer state in optax's layout
# ---------------------------------------------------------------------------


def _i32(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def _by_path(named: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """{port name: array} -> {str(JAX path tuple): array}: the keys flax's
    to_state_dict gives the flat trainable dict the JAX optimizer holds."""
    return {str(path): a for path, a in to_jax.to_jax(named).items()}


def optax_state(optimizer) -> Dict:
    """The port's Optimizer as flax.serialization.to_state_dict of the optax
    state photoverse_tpu/engine/training.py builds: chain(clip_groups_tx,
    adamw) = {"0": {}, "1": {"0": {count, mu, nu}, "1": {}, "2": {count}}},
    wrapped in MultiSteps ({mini_step, gradient_step, inner_opt_state,
    acc_grads, skip_state}) when it accumulates. Host numpy arrays, whole
    leaves: in a multi-rank run every rank takes part in gathering the
    shards and rank 0 receives the state (the others None)."""
    state = optimizer.host_state()
    if state is None:
        return None
    mu, nu, acc = state
    chain = {"0": {}, "1": {"0": {"count": _i32(optimizer.updates), "mu": _by_path(mu), "nu": _by_path(nu)},
                            "1": {}, "2": {"count": _i32(optimizer.updates)}}}
    if optimizer.accum == 1:
        return chain
    return {"mini_step": _i32(optimizer.mini_step), "gradient_step": _i32(optimizer.updates),
            "inner_opt_state": chain,
            "acc_grads": _by_path(acc),
            "skip_state": {}}


def _check_tree(want, got, where="optimizer"):
    """Same keys, array shapes and dtypes (python ints for ints)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            extra = sorted(set(got) - set(want)) if isinstance(got, dict) else got
            missing = sorted(set(want) - set(got)) if isinstance(got, dict) else list(want)
            raise ValueError(f"{where}: the checkpoint's optimizer state does not match this "
                             f"optimizer (missing {missing[:3]}, unexpected {extra[:3]})")
        for k in want:
            _check_tree(want[k], got[k], f"{where}/{k}")
        return
    if not isinstance(got, np.ndarray) or got.shape != want.shape or got.dtype != want.dtype:
        desc = f"{got.dtype}{got.shape}" if isinstance(got, np.ndarray) else type(got).__name__
        raise ValueError(f"{where}: {desc} in the checkpoint, {want.dtype}{want.shape} expected")


@torch.no_grad()
def load_optax_state(optimizer, tree: Dict) -> None:
    """Set the port's Optimizer from an optax state dict (the inverse of
    `optax_state`); the tree must match this optimizer's exactly."""
    _check_tree(optax_state(optimizer), tree)
    chain = tree if optimizer.accum == 1 else tree["inner_opt_state"]
    adam = chain["1"]["0"]
    names = list(optimizer.params)

    def unflat(d):
        return to_jax.from_jax_trainable({_path_from_key(k): v for k, v in d.items()}, names)

    mu, nu = unflat(adam["mu"]), unflat(adam["nu"])
    count = int(adam["count"])
    optimizer.adamw.state.clear()
    for k, p in optimizer.params.items():
        if count:
            optimizer.adamw.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.from_numpy(mu[k]).to(p.device, p.dtype),
                "exp_avg_sq": torch.from_numpy(nu[k]).to(p.device, p.dtype),
            }
    optimizer.updates = count
    if optimizer.accum == 1:
        optimizer.mini_step = 0
        return
    for k, v in unflat(tree["acc_grads"]).items():
        optimizer.acc[k].copy_(torch.from_numpy(v))
    optimizer.mini_step = int(tree["mini_step"])


def _path_from_key(key: str) -> Tuple[str, ...]:
    """str(path tuple) -> the tuple: "('unet', 'mid_attn')" -> ("unet",
    "mid_attn"). Only tuples of plain identifiers are accepted."""
    inner = key.strip()
    if not (inner.startswith("(") and inner.endswith(")")):
        raise ValueError(f"{key!r} is not a tuple key")
    parts = [p.strip() for p in inner[1:-1].split(",") if p.strip()]
    out = []
    for p in parts:
        if len(p) < 2 or p[0] != p[-1] or p[0] not in "'\"" or not p[1:-1].replace("_", "").isalnum():
            raise ValueError(f"{key!r} is not a tuple of names")
        out.append(p[1:-1])
    return tuple(out)


# ---------------------------------------------------------------------------
# native save / load
# ---------------------------------------------------------------------------


def _write_tmp(path: str, data, mode: str) -> str:
    """`data` (bytes / str, or a function of the open file) into path.tmp,
    which a failure removes; returns the tmp path."""
    tmp = path + ".tmp"
    try:
        with open(tmp, mode) as f:
            if callable(data):
                data(f)
            else:
                f.write(data)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return tmp


def _write_atomic(path: str, data, mode: str) -> None:
    os.replace(_write_tmp(path, data, mode), path)


def _ckpt_name(step: Optional[int], final: bool, ext: str) -> str:
    return f"photoverse.{ext}" if final or step is None else f"photoverse_{step:06d}.{ext}"


def save_progress(output_dir: str, snapshot: Dict[str, np.ndarray], step: Optional[int] = None,
                  lora_config: Optional[dict] = None, opt_state: Optional[Dict] = None,
                  final: bool = False) -> str:
    """Write photoverse_{step:06}.msgpack (photoverse.msgpack when final or
    stepless, with the step still embedded) from a `host_save_snapshot`
    and, optionally, an `optax_state`. Returns the path."""
    payload = {"trainable": {"/".join(p): a for p, a in
                             to_jax.to_jax({k: snapshot[k] for k in _trainable_names(snapshot)}).items()}}
    if step is not None:
        payload["step"] = int(step)
    if opt_state is not None:
        payload["optimizer"] = opt_state
    path = os.path.join(output_dir, _ckpt_name(step, final, "msgpack"))
    os.makedirs(output_dir, exist_ok=True)
    tmp = _write_tmp(path, lambda f: msgpack_codec.dump(payload, f), "wb")
    try:
        if lora_config is not None:
            # the sidecar lands first: a LoRA checkpoint without it would
            # load as a rank-0 model that drops the LoRA weights
            _write_atomic(path + ".lora.json", json.dumps(lora_config), "w")
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def _adapter_to_torch_sd(snapshot: Dict[str, np.ndarray], model: str) -> Dict[str, torch.Tensor]:
    """The reference adapter state dict (`mapping_{i}.{0,1,3,4,6}.*`): the
    port's own module names."""
    pre = model + "."
    return {k[len(pre):]: torch.from_numpy(np.array(v, np.float32))
            for k, v in snapshot.items() if k.startswith(pre)}


def _cross_attention_to_torch_sd(snapshot: Dict[str, np.ndarray], use_lora: bool) -> Dict[str, torch.Tensor]:
    """The attn2 keys the reference's save_progress extracts (processor /
    to_q / to_k / to_v, peft's base_layer / lora_A / lora_B naming under
    LoRA): the port's UNet names."""
    out = {}
    for k, v in snapshot.items():
        if not k.startswith("unet.") or ".attn2." not in k:
            continue
        rest = k.split(".attn2.", 1)[1]
        if not rest.startswith(("processor.", "to_q.", "to_k.", "to_v.")):
            continue
        name = k[len("unet."):]
        if not use_lora:
            if ".lora_" in rest:
                continue
            name = name.replace(".base_layer.weight", ".weight")
        out[name] = torch.from_numpy(np.array(v, np.float32))
    return out


def save_progress_pt(output_dir: str, snapshot: Dict[str, np.ndarray], step: Optional[int] = None,
                     lora_config: Optional[dict] = None, final: bool = False) -> str:
    """Write the reference-format photoverse_{step:06}.pt ({image_adapter,
    text_adapter, cross_attention_adapter, lora_config?}, f32), atomically."""
    payload = {
        "image_adapter": _adapter_to_torch_sd(snapshot, "image_adapter"),
        "text_adapter": _adapter_to_torch_sd(snapshot, "text_adapter"),
        "cross_attention_adapter": _cross_attention_to_torch_sd(snapshot, lora_config is not None),
    }
    if lora_config is not None:
        payload["lora_config"] = lora_config
    path = os.path.join(output_dir, _ckpt_name(step, final, "pt"))
    os.makedirs(output_dir, exist_ok=True)
    _write_atomic(path, lambda f: torch.save(payload, f), "wb")
    return path


def _read_native(path: str) -> Dict:
    with open(path, "rb") as f:
        payload = msgpack_codec.unpackb(f.read())
    if not isinstance(payload, dict) or not isinstance(payload.get("trainable"), dict):
        raise ValueError(f"{path}: not a native PhotoVerse checkpoint (no 'trainable' map)")
    return payload


@torch.no_grad()
def _load_native(path: str, models, payload: Optional[Dict] = None) -> None:
    """Copy the checkpoint's trainables into `models` (every trainable
    must be there; extra keys are ignored, as in the JAX package)."""
    payload = payload if payload is not None else _read_native(path)
    trainable, _ = partition_params(models)
    flat = {tuple(k.split("/")): v for k, v in payload["trainable"].items()}
    try:
        arrays = to_jax.from_jax_trainable(flat, trainable)
    except KeyError as e:
        raise ValueError(f"{path}: checkpoint missing trainable keys: {e}") from None
    for k, p in trainable.items():
        a = arrays[k]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{path}: {k} has shape {a.shape} in the checkpoint, {tuple(p.shape)} in the model")
        p.copy_(torch.from_numpy(a))


def load_progress(path: str, models, optimizer=None) -> int:
    """Full resume from a native checkpoint: trainables into `models`, the
    optimizer state into `optimizer` when given and present; returns the
    saved step (0 when the file has none)."""
    payload = _read_native(path)
    _load_native(path, models, payload)
    if optimizer is not None and "optimizer" in payload:
        load_optax_state(optimizer, payload["optimizer"])
    return int(payload.get("step", 0))


# ---------------------------------------------------------------------------
# loading either format
# ---------------------------------------------------------------------------


def _native_lora(path: str) -> Optional[dict]:
    side = path + ".lora.json"
    if not os.path.exists(side):
        return None
    with open(side) as f:
        return json.load(f)


def peek_lora_config(path: str) -> Optional[dict]:
    """The LoRA config a checkpoint carries (the native sidecar, or a
    `.pt`'s `lora_config`), read without building any model, so
    `load_models` can re-inject LoRA before it loads weights."""
    if path.endswith(".msgpack"):
        return _native_lora(path)
    return torch.load(path, map_location="cpu", weights_only=True).get("lora_config")


def load_photoverse_checkpoint(path: str, models) -> Optional[dict]:
    """Load a native `.msgpack` (its trainables) or a reference-format `.pt`
    (both adapters strictly, the cross-attention adapter's attn2 q/k/v with
    their LoRA factors and the identity projections) into `models` in
    place. Returns the LoRA config."""
    if path.endswith(".msgpack"):
        _load_native(path, models)
        return _native_lora(path)
    from photoverse_tpu_torch.convert.from_diffusers import load_cross_attention_adapter

    state = torch.load(path, map_location="cpu", weights_only=True)
    for name in ("image_adapter", "text_adapter"):
        if name in state:
            getattr(models, name).load_state_dict(state[name], strict=True)
    if "cross_attention_adapter" in state:
        load_cross_attention_adapter(models.unet, state["cross_attention_adapter"])
    return state.get("lora_config")


class AsyncCheckpointer:
    """Checkpoint writes on one background thread, so the train loop does
    not wait on serialization and disk. Callers hand it host snapshots
    (`host_save_snapshot`, `optax_state`); tensors among the arguments are
    copied to the host on submit. A write's error is raised by the next
    `submit` or `wait`; `close` drains, raises a stored error, and always
    stops the thread."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # raised on the next submit / wait
                self._error = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @staticmethod
    def _to_host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy().copy()
        if isinstance(x, dict):
            return {k: AsyncCheckpointer._to_host(v) for k, v in x.items()}
        return x

    def submit(self, fn, *args, **kwargs):
        self._check()
        self._q.put((fn, tuple(self._to_host(a) for a in args),
                     {k: self._to_host(v) for k, v in kwargs.items()}))

    def wait(self):
        self._q.join()
        self._check()

    def close(self):
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join()
