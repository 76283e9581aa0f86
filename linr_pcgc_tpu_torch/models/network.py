"""Model configuration, parameters and the flat gather network.

Port of linr_pcgc_tpu/models/network.py.  Parameters are a flat dict of
float32 tensors whose keys (``"block_in.irn.c00.w"``) and insertion order
follow the JAX ``flatten_params`` order exactly: sorted dict keys at every
level, list entries in order.  That order is part of the weight-bitstream
format, so a flat vector (or a JAX ``model.npz``) moves between the
packages unchanged (``params_from_flat``).

The second half is the network on the flat gather backend, the one that
serves every configuration the superbrick layout does not (``outstage``
other than 8, dilated blocks, ``kernel_size`` other than 3): every k^3 conv
is a neighbour gather through a (K, N) map, K10 on the card
(ops/gather_conv.py).  JAX keeps activations feature-major (C, N) for the
TPU's lanes; here they are node-major (N, C), the layout in which K10 reads
a neighbour's channels as one row.  The public functions keep JAX's
layouts: neighbour maps (K, N), occupancy and logits (8, N), level_context
(ch, N).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.gather_conv import gather_conv3
from ..ops.wgrad import gather_conv1_product

STAGE_GROUPS = {
    8: tuple((o,) for o in range(8)),
    4: ((0, 1), (2, 3), (4, 5), (6, 7)),
    3: ((0, 1), (6, 7), (2, 3, 4, 5)),
    2: ((0, 1, 6, 7), (2, 3, 4, 5)),
    1: (tuple(range(8)),),
}

DILATION_LIST = (1, 2)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyper-parameters; defaults match the reference CLI defaults."""

    scale_num: int = 7
    in_channel: int = 7
    hidden_channel_conv: int = 8
    hidden_channel_mlp: int = 24
    embed_dim: int = 8
    scale_mlp_hidden: int = 16
    block_layers: int = 1
    outstage: int = 8
    instage: int = 1
    kernel_size: int = 3
    block_type: str = "inception"

    def __post_init__(self):
        if self.block_layers < 1:
            raise ValueError(f"block_layers must be >= 1, got {self.block_layers}")
        if self.outstage not in STAGE_GROUPS:
            raise ValueError(f"outstage={self.outstage}: supported {sorted(STAGE_GROUPS)}")
        if self.instage != 1:
            raise NotImplementedError(f"instage={self.instage}: only instage=1 is implemented")
        if self.block_type not in ("inception", "resnet", "dilation"):
            raise ValueError(f"unknown block_type {self.block_type!r}")

    @property
    def dilations(self) -> tuple:
        """Dilations whose neighbour maps the model's convs gather over;
        callers stack the maps along the K axis of the map ((D * kvol, N),
        dilation 1 first: _conv3 reads the first kvol rows, _dilated_core
        picks its own)."""
        return DILATION_LIST if self.block_type == "dilation" else (1,)

    @property
    def ch(self) -> int:
        return self.hidden_channel_conv

    @property
    def kvol(self) -> int:
        return self.kernel_size**3

    @property
    def groups(self) -> tuple:
        return STAGE_GROUPS[self.outstage]

    @property
    def group_perm(self) -> tuple:
        """Octant order as the context channels see it (groups concatenated)."""
        return tuple(o for g in self.groups for o in g)

    @property
    def cum_group(self) -> tuple:
        out, c = [], 0
        for g in self.groups:
            c += len(g)
            out.append(c)
        return tuple(out)

    @property
    def ctx_channels(self) -> int:
        return 8 - len(self.groups[-1])

    @property
    def gmax(self) -> int:
        return max(len(g) for g in self.groups)


# ------------------------------------------------------------ param tree --


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: tuple
    init: str            # "uniform" | "zeros" | "normal"
    bound: float = 0.0


def _linear_init(din, dout, lead=()):
    """nn.Linear with xavier_uniform(gain=relu) weights and zero bias."""
    bound = math.sqrt(2.0) * math.sqrt(6.0 / (din + dout))
    return {"w": _Leaf(lead + (din, dout), "uniform", bound),
            "b": _Leaf(lead + (dout,), "zeros")}


def _conv_init(kvol, cin, cout, lead=()):
    """MinkowskiConvolution default init: U(-s, s), s = 1/sqrt(cin*kvol)."""
    s = 1.0 / math.sqrt(cin * kvol)
    shape = (kvol, cin, cout) if kvol > 1 else (cin, cout)
    return {"w": _Leaf(lead + shape, "uniform", s),
            "b": _Leaf(lead + (cout,), "uniform", s)}


def _irn_init(ch, kvol):
    h = ch // 2
    return {"c00": _conv_init(kvol, ch, h), "c01": _conv_init(kvol, h, h),
            "c10": _conv_init(1, ch, h), "c11": _conv_init(kvol, h, h),
            "c12": _conv_init(1, h, h)}


def _resnet_init(ch, kvol):
    return {"r0": _conv_init(kvol, ch, ch), "r1": _conv_init(kvol, ch, ch)}


def _dilated_init(ch, kvol):
    nd = len(DILATION_LIST)
    return {"dc0": [_conv_init(kvol, ch, ch) for _ in range(nd)],
            "dl0": _conv_init(1, ch * nd, ch),
            "dc1": [_conv_init(kvol, ch, ch) for _ in range(nd)],
            "dl1": _conv_init(1, ch * nd, ch)}


def _block_init(cin, ch, cout, kvol, layers=1, block_type="inception"):
    if layers == 1 and block_type == "inception":
        core = {"irn": _irn_init(ch, kvol)}
    else:
        fn = {"inception": _irn_init, "resnet": _resnet_init, "dilation": _dilated_init}[block_type]
        core = {"core": [fn(ch, kvol) for _ in range(layers)]}
    return {"conv_in": _conv_init(kvol, cin, ch), **core, "conv_out": _conv_init(kvol, ch, cout)}


def _param_tree(cfg: ModelConfig):
    S, ch, emb = cfg.scale_num, cfg.ch, cfg.embed_dim
    if cfg.gmax == 1:
        l1 = _linear_init(cfg.hidden_channel_mlp, 1, (cfg.outstage,))
    else:
        l1 = [_linear_init(cfg.hidden_channel_mlp, len(g)) for g in cfg.groups]
    return {
        "scale_emb": _Leaf((S, emb), "normal"),
        "scale_mlp": {
            "l0": _linear_init(emb + cfg.in_channel, cfg.scale_mlp_hidden, (S,)),
            "l1": _linear_init(cfg.scale_mlp_hidden, ch, (S,)),
        },
        "block_in": _block_init(ch, ch, ch, cfg.kvol, cfg.block_layers, cfg.block_type),
        "prune": _conv_init(cfg.kvol, ch, ch, (cfg.outstage,)),
        "inner_mlp": {"l0": _linear_init(ch, cfg.hidden_channel_mlp, (cfg.outstage,)), "l1": l1},
        "outer": [
            _block_init(cfg.cum_group[i], ch, ch, cfg.kvol) for i in range(cfg.outstage - 1)
        ],
    }


def _walk(tree, prefix=""):
    """(key, leaf) pairs in the JAX tree-flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def param_spec(cfg: ModelConfig) -> list:
    """[(key, shape)] in the flatten order — the weight-bitstream layout."""
    return [(k, leaf.shape) for k, leaf in _walk(_param_tree(cfg))]


def init_params(seed: int, cfg: ModelConfig, device="cpu") -> dict:
    """Torch-style random init from a seed (xavier linears, Minkowski-style
    convs, normal scale embedding), drawn leaf by leaf in flatten order."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for key, leaf in _walk(_param_tree(cfg)):
        if leaf.init == "zeros":
            t = torch.zeros(leaf.shape)
        elif leaf.init == "normal":
            t = torch.randn(leaf.shape, generator=gen)
        else:
            t = torch.empty(leaf.shape).uniform_(-leaf.bound, leaf.bound, generator=gen)
        out[key] = t.to(device)
    return out


def param_count(params: dict) -> int:
    return sum(int(p.numel()) for p in params.values())


def flatten_params(params: dict) -> torch.Tensor:
    """1-D view of all parameters in the flatten order."""
    return torch.cat([p.reshape(-1) for p in params.values()])


def unflatten_params(cfg: ModelConfig, flat, device="cpu") -> dict:
    if not torch.is_tensor(flat):
        flat = torch.from_numpy(np.array(flat, np.float32))
    out, pos = {}, 0
    for key, shape in param_spec(cfg):
        n = int(np.prod(shape))
        out[key] = flat[pos: pos + n].reshape(shape).float().to(device)
        pos += n
    if pos != flat.numel():
        raise ValueError(f"flat vector has {flat.numel()} values, the model {pos}")
    return out


def params_from_flat(flat: np.ndarray, cfg: ModelConfig, device="cpu") -> dict:
    """JAX ``flatten_params`` vector -> the port's parameter dict."""
    return unflatten_params(cfg, np.asarray(flat, np.float32), device)


def params_to_flat(params: dict) -> np.ndarray:
    """Inverse of :func:`params_from_flat`."""
    return flatten_params(params).detach().float().cpu().numpy()


def param_tree(params: dict):
    """Nested view (dicts; lists for numbered entries) of a flat dict."""
    root: dict = {}
    for key, t in params.items():
        node = root
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def listify(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [listify(n[str(i)]) for i in range(len(n))]
        return {k: listify(v) for k, v in n.items()}

    return listify(root)


def stack_outer_blocks(tree: dict, cfg: ModelConfig, blocks=None) -> dict:
    """Stack the ragged per-stage context blocks into dense tensors, the
    conv_in input channels zero-padded to ``ctx_channels`` (exact: zero
    weights contribute 0.0), so a stage index selects a block by row.
    ``blocks`` (host indices, repeats allowed) stacks only those blocks, in
    that order; all of them by default."""
    k = cfg.ctx_channels
    blocks = range(len(tree["outer"])) if blocks is None else blocks
    outer = [tree["outer"][i] for i in blocks]
    conv_in_w = torch.stack([
        torch.nn.functional.pad(p["conv_in"]["w"], (0, 0, 0, k - cfg.cum_group[i]))
        for i, p in zip(blocks, outer)
    ])

    def stack(fn):
        first = fn(outer[0])
        return {
            name: {leaf: torch.stack([fn(p)[name][leaf] for p in outer]) for leaf in first[name]}
            for name in first
        }

    return {
        "conv_in_w": conv_in_w,
        "conv_in_b": torch.stack([p["conv_in"]["b"] for p in outer]),
        "irn": stack(lambda p: p["irn"]),
        "conv_out": {leaf: torch.stack([p["conv_out"][leaf] for p in outer])
                     for leaf in ("b", "w")},
    }


# ------------------------------------------------------ the gather network --

LN2 = math.log(2.0)


def _conv1(x, p):
    """1x1x1 conv: (N, Cin) -> (N, Cout); its weight gradient is K11."""
    return gather_conv1_product(x, p["w"]) + p["b"]


def _conv3(x, idx_t, p):
    """k^3 submanifold conv: x (N, Cin), idx_t (K', N) neighbour map (-1
    absent), p["w"] (K, Cin, Cout) -> (N, Cout).  K' may exceed K:
    dilated configs stack per-dilation maps along K, and a conv reads only
    its first K rows."""
    return gather_conv3(x, idx_t[: p["w"].shape[0]], p["w"], p["b"])


def _irn(x, idx_t, p):
    out0 = _conv3(torch.relu(_conv3(x, idx_t, p["c00"])), idx_t, p["c01"])
    out1 = _conv1(torch.relu(_conv3(torch.relu(_conv1(x, p["c10"])), idx_t, p["c11"])), p["c12"])
    return torch.cat([out0, out1], dim=1) + x


def _resnet_core(x, idx_t, p):
    return x + _conv3(torch.relu(_conv3(x, idx_t, p["r0"])), idx_t, p["r1"])


def _dilated_core(x, idx_t, p):
    """DilatedResNet: per-dilation conv banks, channel concat, 1x1 mix;
    twice; residual add.  Each bank conv gets its own kvol rows of the
    stacked map."""
    kvol = p["dc0"][0]["w"].shape[0]
    maps = [idx_t[i * kvol: (i + 1) * kvol] for i in range(len(p["dc0"]))]
    out = torch.cat([_conv3(x, m, c) for m, c in zip(maps, p["dc0"])], dim=1)
    out = torch.relu(_conv1(out, p["dl0"]))
    out = torch.cat([_conv3(out, m, c) for m, c in zip(maps, p["dc1"])], dim=1)
    return _conv1(out, p["dl1"]) + x


def _block_core(y, idx_t, p):
    """ResNetBlock: the ``core`` layers stacked (kind by parameter keys),
    an extra outer skip when there are more than one."""
    if "irn" in p:
        return _irn(y, idx_t, p["irn"])
    out = y
    for lp in p["core"]:
        if "c00" in lp:
            out = _irn(out, idx_t, lp)
        elif "dc0" in lp:
            out = _dilated_core(out, idx_t, lp)
        else:
            out = _resnet_core(out, idx_t, lp)
    if len(p["core"]) > 1:
        out = out + y
    return out


def _block(x, idx_t, p):
    y = torch.relu(_conv3(x, idx_t, p["conv_in"]))
    y = _block_core(y, idx_t, p)
    return _conv3(y, idx_t, p["conv_out"])


def _mlp2(x, l0, l1):
    return _conv1(torch.relu(_conv1(x, l0)), l1)


def scale_input_lut(params, cfg: ModelConfig):
    """(S, 128, ch) table of the per-scale input MLP over all 7-bit
    neighbour-feature codes."""
    dev = params["scale_emb"].device
    codes = torch.arange(128, dtype=torch.int32, device=dev)
    bits = ((codes[:, None] >> torch.arange(7, dtype=torch.int32, device=dev)[None]) & 1).float()
    emb = params["scale_emb"]
    x = torch.cat([emb[:, None, :].expand(-1, 128, -1), bits[None].expand(emb.shape[0], -1, -1)],
                  dim=2)  # (S, 128, emb + 7)
    sm = params["scale_mlp"]
    h = torch.relu(torch.matmul(x, sm["l0"]["w"]) + sm["l0"]["b"][:, None, :])
    return torch.matmul(h, sm["l1"]["w"]) + sm["l1"]["b"][:, None, :]


def _input_features(params, cfg: ModelConfig, scale_code):
    """The input embedding per node, scale_code = scale_id * 128 +
    feat_code (N,): (N, ch)."""
    lut = scale_input_lut(params, cfg)
    return lut.reshape(-1, lut.shape[-1])[scale_code.long()]


def stage_context_traced(params, cfg: ModelConfig, stage: int, x_glob, occ7, idx_t):
    """Context of stage ``stage``: x_glob (N, ch) plus, from stage 1 on, the
    occupancy-context block over the bits coded before the stage.  ``occ7``
    (N, ctx_channels) is in group-perm octant order; the block reads only
    its first ``cum_group[stage - 1]`` channels, the bits already coded, so
    the encoder may pass the whole ground truth and the decoder its partial
    buffer.  JAX pads every block's conv_in to ctx_channels inputs and masks
    the rest to zero, which adds only exact zeros.  Stage 0 is x_glob itself
    (JAX adds 0.0 times the block)."""
    if stage == 0:
        return x_glob
    vis = cfg.cum_group[stage - 1]
    return x_glob + _block(occ7[:, :vis], idx_t, params["outer"][stage - 1])


def stack_heads(params, cfg: ModelConfig) -> dict:
    """(outstage, hidden, gmax) / (outstage, gmax) view of the per-stage
    l1 heads; ragged groupings zero-pad each stage's width to ``gmax``
    (the callers drop the pad logits)."""
    l1 = params["inner_mlp"]["l1"]
    if not isinstance(l1, list):
        return l1
    g = cfg.gmax
    return {
        "w": torch.stack([torch.nn.functional.pad(p["w"], (0, g - p["w"].shape[1])) for p in l1]),
        "b": torch.stack([torch.nn.functional.pad(p["b"], (0, g - p["b"].shape[0])) for p in l1]),
    }


def stage_head_traced(params, cfg: ModelConfig, stage: int, ctx, idx_t):
    """Logits (N, gmax) of the stage's group bits (columns past the
    group's width are padding): the prune conv, then the [ch -> hidden ->
    gmax] MLP."""
    h = _conv3(ctx, idx_t, {"w": params["prune"]["w"][stage], "b": params["prune"]["b"][stage]})
    im = params["inner_mlp"]
    l1s = stack_heads(params, cfg)
    return _mlp2(h, {"w": im["l0"]["w"][stage], "b": im["l0"]["b"][stage]},
                 {"w": l1s["w"][stage], "b": l1s["b"][stage]})


def stage_logits(params, cfg: ModelConfig, stage: int, x_glob, occ_t, idx_t):
    """Logits (len(group), N) of one static stage, in JAX's feature-major
    layout: x_glob (ch, N), occ_t (cum_group[stage - 1], N) the group bits
    coded before the stage in group-perm order (empty at stage 0), idx_t
    (K, N).  The API form of stage_context_traced + stage_head_traced."""
    ctx = stage_context_traced(params, cfg, stage, x_glob.T, occ_t.T, idx_t)
    logits = stage_head_traced(params, cfg, stage, ctx, idx_t)
    return logits[:, : len(cfg.groups[stage])].T


def forward_all_stages(params, cfg: ModelConfig, scale_id, feat_code, idx_t, occ_t):
    """Training forward over a flat multi-scale node array: scale_id and
    feat_code (N,) int32, idx_t (K, N) int32 (-1 absent), occ_t (8, N)
    float32 ground truth.  Returns logits (8, N) in octant order.

    The stages run one after another in a Python loop (JAX scans them);
    nothing is recomputed: K10's autograd Function keeps only each conv's
    input, so a stage's saved activations are a few (N, 8) tensors."""
    intensor = _input_features(params, cfg, scale_id * 128 + feat_code)
    x_glob = _block(intensor, idx_t, params["block_in"])
    occ_ctx = occ_t[list(cfg.group_perm)][: cfg.ctx_channels].T
    rows = [None] * 8
    for g, grp in enumerate(cfg.groups):
        ctx = stage_context_traced(params, cfg, g, x_glob, occ_ctx, idx_t)
        logits = stage_head_traced(params, cfg, g, ctx, idx_t)
        for j, o in enumerate(grp):
            rows[o] = logits[:, j]
    return torch.stack(rows)


def training_bits(params, cfg: ModelConfig, scale_id, feat_code, idx_t, occ_t, mask):
    """Code length in bits over the valid nodes (``mask`` (N,)): the sum of
    the stable sigmoid BCE over ln 2."""
    logits = forward_all_stages(params, cfg, scale_id, feat_code, idx_t, occ_t)
    bce = torch.relu(logits) - logits * occ_t + torch.log1p(torch.exp(-logits.abs()))
    return torch.where(mask[None, :], bce, torch.zeros_like(bce)).sum() / LN2


def level_context(params, cfg: ModelConfig, scale_idx: int, feat_code, idx_t):
    """The global context of one codec level: block_in over the input
    embedding, (ch, N) as in JAX."""
    intensor = _input_features(params, cfg, scale_idx * 128 + feat_code)
    return _block(intensor, idx_t, params["block_in"]).T
