"""Fused GMM VBE step (responsibilities + sufficient statistics).

Port of `repro.kernels.gmm_estep`.  The per-node VBE hot loop of the
paper's application is O(T * K * D^2): per data point a quadratic form per
component, a row softmax, then three accumulations (R_k, sum r x,
sum r x x^T).  On the card it runs as one hand-written CUDA kernel launch
(`csrc/gmm_estep.cu`, one pass over x, statistics accumulated on chip and
written once); its design and bound are in the source's header note.

Inputs are the per-component terms of `core.gmm.estep_terms`:
  log_prior (N,K)  Wn (N,K,D,D)=nu W  b (N,K,D)=nu W m  c (N,K)=D/beta+nu mWm
and an optional per-component `shift` s (N,K,D): the step then works in
each component's coordinates y = x - s_k (terms from
`estep_terms(q, shift=s)`) and returns centred statistics, sum r y and
sum r y y^T.  Without a shift it is exactly the reference kernel.  The
engine centres on the component means, which keeps f32 statistics well
conditioned at deployment scale (see `core.gmm.posterior_from_stats`).

`gmm_estep_nodes` is the wrapper: it validates the inputs, then launches
a kernel for CUDA tensors and runs the plain PyTorch version
(`gmm_estep_nodes_plain`, the same function written as batched tensor
ops) for CPU tensors.  Nothing falls back: a CUDA tensor launches a
kernel or raises.  `gmm_estep_nodes.launches` counts the kernel launches
(`gmm_estep_nodes.variant_launches` those of each kernel).

Three kernel paths, chosen by shape alone (`kernel_variant`):
* "registers" when K * (1 + D + D(D+1)/2) <= REG_STATS_BUDGET (K <= 4 at
  D = 2, K <= 8 at D = 1, K <= 2 at D = 3, K = 1 at D = 4, 5): one block
  of REG_THREADS per node, statistics in registers, log rho once per point
  and component, vector loads;
* "shared" for the other shapes with D <= MAX_D and K <= SHARED_KMAX[D]
  whose shared memory fits at the default block_t: one block of
  SHARED_THREADS per node, `block_t` points staged a tile.  Operations
  bound it, and it runs them on the FP64 tensor cores: each point becomes
  its features phi = the upper triangle of x' x'^T, x' = (x, 1) ((D+1)(D+2)
  /2 of them, in a warp's f64 tile in shared memory), each component's
  terms (with the shift and log_prior) fold once a node into a vector u_k
  on the same triangle, so log rho = phi . u_k is one m16n8k8 product
  chain a warp's 16 points by 8 components, formed once; the softmax stays
  in registers; sum_t r_tk phi(x_t) (R, sum_x and sum_xx at once) is an
  m16n8k16 product held in each warp's registers across the node's tiles,
  the warps' sums added in warp order and centred in f64 at emit.  When a
  node's component blocks of 8 exceed what a warp holds (`shared_plan`'s
  `chunked`: e.g. K > 32 at D <= 4, K > 16 above), an lse pass first
  writes each point's largest log rho and softmax denominator to a
  workspace (`shared_workspace_bytes`) and passes of blocks follow;
* "wide" for the rest (the paper's D = 34 and D = 52 tables): any K and
  D.  log rho and the statistics run on the FP64 tensor cores (m16n8k8
  and m16n8k16 DMMA): a prep launch folds each component's terms into one
  f64 matrix U_k (x'^T U_k x' is the quadratic form of x' = (x, 1), kept
  on the blocks on or above the 8 x 8 diagonal), then blocks of
  WIDE_THREADS take WIDE_TILE-point tiles, and each warp holds up to
  WIDE_ITEMS 16 x 8 blocks of sum r x' x'^T in registers across the
  node's tiles; an emit launch centres them on `shift` in f64 and writes
  f32.  When a node's statistics need more than one block
  (`wide_plan`'s `nby` > 1: e.g. K > 4 at D = 52, K > 2 at D = 64), a
  first launch writes each point's softmax terms and the blocks split
  the components (`wide_workspace_bytes` sizes the scratch).

Contracts, shared by the kernels and the plain version:
* x streams as f32 or bf16 (one kernel instance each); an f64 x is cast
  to f32, as the TPU kernel does (the engine casts once per session, see
  `core.backends.FusedBackend.stream_data`).  mask has x's dtype.
  Products and statistics are f32 on the register path and f64 on the
  tensor cores on the other two, emitted as f32.
* `return_r=False` never allocates or writes r.
* Statistics are BIT-invariant to trailing mask-zero padding of the point
  axis, and two launches on the same inputs are bit-identical (no
  atomics; summation order independent of T).
* `replication` scales the statistics at emit; a Python number, so no
  host sync.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from repro_torch.core.expfam import ordered_sum

#: the register and shared paths are instantiated for D = 1..MAX_D (the
#: wide path takes any D)
MAX_D = 8
#: the shared path's tile when the caller does not choose one; the
#: dispatch rule sizes the shared path's shared memory at it
DEFAULT_BLOCK_T = 512
#: shared path: threads per block (one block per node), points a warp takes
#: at a time, row stride (floats) of a warp's r transpose (kSmThreads,
#: kSmStep, kSmRt in the source)
SHARED_THREADS = 256
SHARED_STEP = 16
SHARED_RT = 20
#: block_t is a multiple of this (every warp takes whole steps) and at
#: most 4 x SHARED_THREADS (each thread stages four mask values a tile)
SHARED_TILE_STEP = SHARED_THREADS // 32 * SHARED_STEP
#: wide path: threads per block, points per tile (halved while a tile does
#: not fit), statistics items a warp holds, k-steps (of 8 coordinates) of
#: A fragments a warp holds, components whose log rho rows a block holds
#: (kWideThreads,
#: kWideTile, kWideItems, kWideSteps, kWideComps in the source)
WIDE_THREADS = 256
WIDE_TILE = 128
WIDE_ITEMS = 9
WIDE_STEPS = 5
WIDE_COMPS = 32
#: shared memory a block may use on Hopper
MAX_SMEM_BYTES = 227 * 1024
#: floats of per-thread statistics the register path holds (kRegBudget)
REG_STATS_BUDGET = 24
#: register path: threads per block (one block per node), consecutive
#: points a thread takes per tile, points per tile
REG_THREADS = 128
REG_GROUP = 4
REG_TILE = REG_THREADS * REG_GROUP
#: largest N and T the kernels' int indexing and grid take
MAX_NODES = 2 ** 31 - 1
MAX_POINTS = 2 ** 31 - 1 - 4096

_X_DTYPES = (torch.float32, torch.bfloat16)


def stats_per_component(D: int) -> int:
    """R, sum_x (D) and the upper triangle of sum_xx (D(D+1)/2)."""
    return 1 + D + D * (D + 1) // 2


def reg_kmax(D: int) -> int:
    """The register path's largest K at dimension D (KMAX in the source;
    0: the register path takes no K at this D)."""
    return REG_STATS_BUDGET // stats_per_component(D)


def shared_cbmax(D: int) -> int:
    """Component blocks of 8 whose statistics a shared-path warp holds in
    registers (sm_cbmax in the source); the kernel's instances take 1 or
    this many."""
    return 4 if D <= 4 else 2


def _first_layout_kmax(D: int) -> int:
    """The largest K whose terms and per-warp statistics slots (four warps
    at block_t = 512, 4 (2 + 2 D + D^2 + 4 (1 + D + D(D+1)/2)) bytes a
    component) filled a block in the shared path's first layout: the K
    range the shared path has taken since, kept so that the dispatch does
    not move with the kernel's layout."""
    return MAX_SMEM_BYTES // (4 * (2 + 2 * D + D * D
                                   + 4 * stats_per_component(D)))


#: the shared path's largest K at D = 1..MAX_D (before its shared-memory
#: check): 3418, 1709, 1019, 675, 480, 358, 278, 221
SHARED_KMAX = {D: _first_layout_kmax(D) for D in range(1, 9)}


def shared_plan(K: int, D: int, esize: int = 4,
                block_t: int = DEFAULT_BLOCK_T) -> dict:
    """The shared path's plan at (K, D), x elements of `esize` bytes and
    `block_t` points a tile, as `sm_plan` in the source.  F = (D+1)(D+2)/2
    features; NS k-steps of 8 (log rho), NF row blocks of 16 (the
    statistics), XS = 16 NF + 4 doubles a row of a warp's phi tile (row p
    at p XS + p // 4: conflict-free for its stores and both products'
    loads).  ncb component blocks of 8; cbm of them a warp (the kernel
    instance: 1, or `shared_cbmax(D)` when ncb > 1); chunked = 1 when
    ncb > cbm (an lse pass, then npass statistics passes), else one fused
    pass.  smem: the u
    fragments (ncb NS 512 bytes), then the warps' phi tiles, r transposes
    (with each point's mask / denominator) and, when cbm > 1, log rho of
    their blocks, two raw x tiles and two mask tiles, or the warps'
    statistics at the end of a pass, whichever is larger."""
    F = (D + 1) * (D + 2) // 2
    NS, NF = -(-F // 8), -(-F // 16)
    XS = 16 * NF + 4
    ncb = -(-K // 8)
    cbm = 1 if ncb <= 1 else shared_cbmax(D)
    warps = SHARED_THREADS // 32
    raw = (block_t * D * esize + 15) // 16 * 16 + 16
    u = ncb * NS * 512
    area = (warps * (SHARED_STEP * XS + 4) * 8
            + warps * (cbm * 8 * SHARED_RT + SHARED_STEP) * 4
            + (warps * cbm * 128 * 8 if cbm > 1 else 0)
            + 2 * raw + 2 * block_t * 4)
    red = warps * cbm * NF * 128 * 8
    return {"F": F, "NS": NS, "NF": NF, "XS": XS, "ncb": ncb, "cbm": cbm,
            "chunked": int(ncb > cbm), "npass": -(-ncb // cbm), "raw": raw,
            "smem": u + max(area, red)}


def smem_bytes(K: int, D: int, block_t: int, esize: int = 4) -> int:
    """Dynamic shared memory of one shared-path block (`shared_plan`).
    (The register path's shared memory is static, < 1 KB.)"""
    return shared_plan(K, D, esize, block_t)["smem"]


def shared_workspace_bytes(N: int, T: int, K: int, D: int) -> int:
    """The shared path's device scratch for one call: when a node's
    components take several passes (`shared_plan`'s chunked), each point's
    largest log rho (f64) and softmax denominator (f32), each part
    256-byte aligned; else 0."""
    if not shared_plan(K, D)["chunked"]:
        return 0
    al = lambda b: -(-b // 256) * 256  # noqa: E731
    return al(N * T * 8) + al(N * T * 4)


def kernel_variant(K: int, D: int) -> str:
    """Which CUDA kernel a (K, D) shape launches: "registers" when its
    K (1 + D + D(D+1)/2) statistics fit REG_STATS_BUDGET floats, else
    "shared" when D <= MAX_D, K <= SHARED_KMAX[D] and the shared path's
    memory at DEFAULT_BLOCK_T (f32 x) fits a block, else "wide".  A
    function of the shape alone, never of T or N.

    >>> kernel_variant(3, 2), kernel_variant(5, 2), kernel_variant(2, 34)
    ('registers', 'shared', 'wide')
    """
    if K <= reg_kmax(D):
        return "registers"
    if (D <= MAX_D and K <= SHARED_KMAX[D]
            and smem_bytes(K, D, DEFAULT_BLOCK_T) <= MAX_SMEM_BYTES):
        return "shared"
    return "wide"


def wide_plan(K: int, D: int, esize: int = 4) -> dict:
    """The wide path's plan at (K, D) for x elements of `esize` bytes, as
    `wide_plan` in the source.  x' = (x, 1) has Dq = D + 1 coordinates;
    the quadratic form takes nS = nJ k-steps of 8 coordinates (m16n8k8)
    and nJ column blocks of 8 (block J: k-steps 0 .. J, the blocks on or
    above the 8 x 8 diagonal: nfrag fragments); the statistics are 16 x 8
    items (row block I < nI, column block J >= 2I: nitems a component),
    m16n8k16 products over 16 points.
    A block takes kb components (at most WIDE_COMPS, and WIDE_ITEMS items
    a warp), or one component's items over nsplit blocks; nby blocks a
    node.  tp points a tile: WIDE_TILE, halved while the f64 tile (row
    stride xs), two raw tiles and kq rows of q do not fit MAX_SMEM_BYTES;
    xg = 1 when none fits (x then read from global memory); su = 1 when
    a fused or split block's U fragments fit beside them (staged once,
    else read from global memory)."""
    Dq = D + 1
    nJ, nI = (Dq + 7) // 8, (Dq + 15) // 16
    nS, nfrag = nJ, nJ * (nJ + 1) // 2
    nitems = sum(nJ - 2 * I for I in range((nJ + 1) // 2))
    cap = (WIDE_THREADS // 32) * WIDE_ITEMS
    if nitems <= cap:
        kb = min(K, WIDE_COMPS, cap // nitems)
        nsplit, per, nby = 1, 0, -(-K // kb)
    else:
        kb, nsplit = 0, -(-nitems // cap)
        per = -(-nitems // nsplit)
        nby = K * nsplit
    kq = min(K, WIDE_COMPS)
    xs = 16 * nI + 4
    tp, xg, raw = WIDE_TILE, 1, 0
    t = WIDE_TILE
    while t >= 16:
        r = (t * D * esize + 15) // 16 * 16 + 16
        if t * xs * 8 + 2 * r + kq * t * 8 + t * 4 <= MAX_SMEM_BYTES:
            tp, xg, raw = t, 0, r
            break
        t //= 2
    area = ((0 if xg else tp * xs * 8) + 2 * raw + kq * tp * 8 + tp * 4
            + -(-kq * 8 // 16) * 16)
    ub = (kb if kb > 0 else 1) * nfrag * 512
    su = int(area + ub <= MAX_SMEM_BYTES)
    area += ub if su else 0
    smem = max(area, (WIDE_THREADS // 32) * WIDE_ITEMS * 128 * 8)
    return {"Dq": Dq, "nS": nS, "nJ": nJ, "nI": nI, "nfrag": nfrag,
            "nitems": nitems, "ntri": Dq * (Dq + 1) // 2, "kb": kb,
            "nsplit": nsplit, "per": per, "nby": nby, "kq": kq, "tp": tp,
            "xs": xs, "xg": xg, "raw": raw, "su": su, "smem": smem}


def wide_workspace_bytes(N: int, T: int, K: int, D: int,
                         esize: int = 4) -> int:
    """The wide path's device scratch for one call: the U fragments
    (N K nfrag 64 f64), v (N K D f64), the statistics' upper triangles
    (N K Dq(Dq+1)/2 f64) and, when nby > 1, each point's largest log rho
    (f64) and softmax denominator (f32); each part 256-byte aligned."""
    P = wide_plan(K, D, esize)
    al = lambda b: -(-b // 256) * 256  # noqa: E731
    total = (al(N * K * P["nfrag"] * 64 * 8) + al(N * K * D * 8)
             + al(N * K * P["ntri"] * 8))
    if P["nby"] > 1:
        total += al(N * T * 8) + al(N * T * 4)
    return total


def supported(K: int, D: int) -> bool:
    """Whether a kernel takes the (K, D) shape: every K, D >= 1 (the wide
    path splits a node's statistics over blocks and, past a block's
    shared memory, reads x from global memory)."""
    return K >= 1 and D >= 1


def vector_loads(x: torch.Tensor, mask: torch.Tensor) -> bool:
    """Whether the register path may load x and mask in whole vectors of
    four elements: T % 4 == 0 (every node's base then stays aligned) and
    both arrays start on a 16-byte boundary.  Otherwise it loads scalars;
    the result is the same either way."""
    return (x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0
            and mask.data_ptr() % 16 == 0)


#: (K, D, block_t) shapes at which `_lib` holds the wrapper's shared plan to
#: the source's: one block, several blocks a warp, the lse pass and
#: statistics passes, every D, the largest tile
SHARED_PLAN_CHECKS = ((5, 2, 512), (8, 2, 512), (32, 3, 512), (4, 8, 512),
                      (221, 8, 512), (17, 6, 128), (1019, 3, 1024),
                      (9, 1, 256), (40, 4, 384), (30, 5, 512), (12, 7, 640))
#: (K, D) shapes at which `_lib` holds the wrapper's wide plan to the
#: source's: single-block nodes, split nodes, a split component, a tile
#: halved, x read from global memory
WIDE_PLAN_CHECKS = ((1, 1), (2, 34), (6, 52), (13, 64), (2, 110), (227, 8),
                    (3, 200), (1, 900), (2, 2000))


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import build
    return _bind(build.load("gmm_estep"))


def _bind(lib):
    """The launch entry of a loaded csrc/gmm_estep.cu library, its
    argument types set, after checking the source's register budget and
    wide plan against the wrapper's."""
    fn = lib.gmm_estep_nodes_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    kmax = lib.gmm_estep_reg_kmax
    kmax.argtypes, kmax.restype = [ctypes.c_int], ctypes.c_int
    for D in range(1, MAX_D + 1):
        if kmax(D) != reg_kmax(D):
            raise RuntimeError(f"csrc/gmm_estep.cu's register path takes "
                               f"K <= {kmax(D)} at D={D}; the wrapper "
                               f"dispatches K <= {reg_kmax(D)}")
    plan = lib.gmm_estep_wide_plan
    plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    plan.restype = None
    work = lib.gmm_estep_wide_workspace_bytes
    work.argtypes, work.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    keys = ("tp", "xg", "nby", "kb", "nsplit", "nitems", "nfrag", "su",
            "smem")
    for K, D in WIDE_PLAN_CHECKS:
        for esize in (4, 2):
            out = (ctypes.c_int * 9)()
            plan(K, D, int(esize == 2), ctypes.addressof(out))
            want = wide_plan(K, D, esize)
            if list(out) != [want[k] for k in keys]:
                raise RuntimeError(f"csrc/gmm_estep.cu's wide plan at K={K},"
                                   f" D={D}, esize={esize} is {list(out)}; "
                                   f"the wrapper's is "
                                   f"{[want[k] for k in keys]}")
            if work(3, 77, K, D, int(esize == 2)) != wide_workspace_bytes(
                    3, 77, K, D, esize):
                raise RuntimeError(f"csrc/gmm_estep.cu's wide workspace at "
                                   f"K={K}, D={D} differs from the "
                                   f"wrapper's")
    splan = lib.gmm_estep_shared_plan
    splan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    splan.restype = None
    swork = lib.gmm_estep_shared_workspace_bytes
    swork.argtypes, swork.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    keys = ("ncb", "cbm", "chunked", "npass", "XS", "smem")
    for K, D, block_t in SHARED_PLAN_CHECKS:
        for esize in (4, 2):
            out = (ctypes.c_int * 6)()
            splan(K, D, int(esize == 2), block_t, ctypes.addressof(out))
            want = shared_plan(K, D, esize, block_t)
            if list(out) != [want[k] for k in keys]:
                raise RuntimeError(f"csrc/gmm_estep.cu's shared plan at K={K},"
                                   f" D={D}, esize={esize}, block_t={block_t}"
                                   f" is {list(out)}; the wrapper's is "
                                   f"{[want[k] for k in keys]}")
        if swork(3, 77, K, D) != shared_workspace_bytes(3, 77, K, D):
            raise RuntimeError(f"csrc/gmm_estep.cu's shared workspace at "
                               f"K={K}, D={D} differs from the wrapper's")
    return fn


def _check(x, mask, log_prior, Wn, b, c, shift, block_t, replication):
    """Validate and normalise the inputs; returns (x, mask) in the
    streaming dtype.  Raises on what the kernels do not take."""
    if x.dim() != 3:
        raise ValueError(f"x must be (N, T, D): {tuple(x.shape)}")
    N, T, D = x.shape
    if N > MAX_NODES:
        raise ValueError(f"the kernels take at most {MAX_NODES} nodes: "
                         f"N={N}")
    if T > MAX_POINTS:
        raise ValueError(f"the kernels take at most {MAX_POINTS} points a "
                         f"node: T={T}")
    if (isinstance(replication, torch.Tensor)
            or not isinstance(replication, numbers.Real)):
        raise TypeError(f"replication must be a Python number (a tensor "
                        f"would need a host sync): {type(replication)}")
    if x.dtype == torch.float64:
        x = x.float()
        if mask.dtype == torch.float64:
            mask = mask.float()
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x must be float32, bfloat16 or float64: {x.dtype}")
    if mask.dtype != x.dtype:
        raise TypeError(f"mask dtype {mask.dtype} != x dtype {x.dtype}")
    if tuple(mask.shape) != (N, T):
        raise ValueError(f"mask must be {(N, T)}: {tuple(mask.shape)}")
    K = log_prior.shape[-1] if log_prior.dim() == 2 else -1
    want = {"log_prior": (log_prior, (N, K)), "Wn": (Wn, (N, K, D, D)),
            "b": (b, (N, K, D)), "c": (c, (N, K))}
    if shift is not None:
        want["shift"] = (shift, (N, K, D))
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape or K < 1:
            raise ValueError(f"{name} must be {shape}: {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32: {a.dtype}")
    for name, a in (("x", x), ("mask", mask), *((n, a) for n, (a, _) in
                                                 want.items())):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D < 1:
        raise ValueError(f"the kernels take D >= 1: D={D}")
    step = SHARED_TILE_STEP
    if block_t % step or not step <= block_t <= 4 * SHARED_THREADS:
        raise ValueError(f"block_t must be a multiple of {step} in "
                         f"[{step}, {4 * SHARED_THREADS}]: {block_t}")
    variant = kernel_variant(K, D)
    need = smem_bytes(K, D, block_t, x.element_size())
    if variant == "shared" and need > MAX_SMEM_BYTES:
        raise ValueError(
            f"K={K}, D={D}, block_t={block_t} needs {need} B of shared "
            f"memory; a Hopper block has {MAX_SMEM_BYTES}")
    return x, mask


_VARIANT_CODE = {"registers": 0, "shared": 1, "wide": 2}


def _launch(x, mask, log_prior, Wn, b, c, shift, replication, block_t,
            return_r):
    """One kernel launch (`kernel_variant` picks it) on validated inputs."""
    N, T, D = x.shape
    K = log_prior.shape[-1]
    r = (torch.empty((N, T, K), dtype=torch.float32, device=x.device)
         if return_r else None)
    stats = torch.empty((N, K + K * D + K, D), dtype=torch.float32,
                        device=x.device)
    variant = kernel_variant(K, D)
    work = None
    if N > 0 and variant == "wide":
        nbytes = wide_workspace_bytes(N, T, K, D, x.element_size())
    elif N > 0 and variant == "shared":
        nbytes = shared_workspace_bytes(N, T, K, D)
    else:
        nbytes = 0
    if nbytes:
        work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    if N > 0:
        err = _lib()(x.data_ptr(), mask.data_ptr(), log_prior.data_ptr(),
                     Wn.data_ptr(), b.data_ptr(), c.data_ptr(),
                     None if shift is None else shift.data_ptr(),
                     r.data_ptr() if return_r else None, stats.data_ptr(),
                     N, T, K, D, block_t, float(replication),
                     int(x.dtype == torch.bfloat16),
                     (smem_bytes(K, D, block_t, x.element_size())
                      if variant == "shared" else 0),
                     _VARIANT_CODE[variant], int(vector_loads(x, mask)),
                     torch.cuda.current_stream(x.device).cuda_stream,
                     None if work is None else work.data_ptr())
        if err != 0:
            raise RuntimeError(f"gmm_estep_nodes kernel launch failed: "
                               f"cudaError {err}")
        gmm_estep_nodes.launches += 1
        gmm_estep_nodes.variant_launches[variant] += 1
    return r, stats


def _unpack_stats(stats, K, D):
    N = stats.shape[0]
    sum_x = stats[:, 0:K, :]
    sum_xx = stats[:, K:K + K * D, :].reshape(N, K, D, D)
    R = stats[:, K + K * D:, 0]
    return R, sum_x, sum_xx


def gmm_estep_nodes(x, mask, log_prior, Wn, b, c, replication=1.0, *,
                    shift=None, block_t: int = 512, return_r: bool = True):
    """Whole-network fused VBE step: x (N, T, D), mask (N, T) and per-node
    terms.  Returns (r (N, T, K) or None, R (N, K), sum_x (N, K, D),
    sum_xx (N, K, D, D)), the statistics scaled by `replication` (and
    centred on `shift`, when given).

    CUDA tensors launch one kernel (`kernel_variant` says which; `block_t`
    is the shared path's tile, points staged at a time); CPU tensors run
    the plain version.
    """
    x, mask = _check(x, mask, log_prior, Wn, b, c, shift, block_t,
                     replication)
    if x.device.type == "cpu":
        return gmm_estep_nodes_plain(x, mask, log_prior, Wn, b, c,
                                     replication, shift=shift,
                                     return_r=return_r)
    if x.device.type != "cuda":
        raise ValueError(f"no gmm_estep kernel for device {x.device}")
    r, stats = _launch(x, mask, log_prior, Wn, b, c, shift, replication,
                       block_t, return_r)
    return (r, *_unpack_stats(stats, log_prior.shape[-1], x.shape[-1]))


gmm_estep_nodes.launches = 0
#: the launches of each kernel (`kernel_variant`), counted with `launches`
gmm_estep_nodes.variant_launches = {"registers": 0, "shared": 0, "wide": 0}


def gmm_estep(x, mask, log_prior, Wn, b, c, *, block_t: int = 512):
    """Single-node view: x (T, D), mask (T,).  Returns (r (T, K), R (K,),
    sum_x (K, D), sum_xx (K, D, D)), unreplicated."""
    r, R, sum_x, sum_xx = gmm_estep_nodes(
        x[None], mask[None], log_prior[None], Wn[None], b[None], c[None],
        block_t=block_t)
    return r[0], R[0], sum_x[0], sum_xx[0]


# ---------------------------------------------------------------------------
# The plain PyTorch version (CPU path of the wrapper; the card's oracle)
# ---------------------------------------------------------------------------
def gmm_estep_nodes_plain(x, mask, log_prior, Wn, b, c, replication=1.0, *,
                          shift=None, return_r: bool = True,
                          dtype=torch.float32):
    """The kernel's function as batched tensor ops (the reference oracle
    `repro.kernels.ref.gmm_estep_nodes`, f32 products), with the
    statistics folded through `ordered_sum` so that they are bit-invariant
    to trailing mask-zero padding, like the kernel's.  `dtype=float64`
    evaluates the same function in f64: the exact answer the wide path is
    held against where f32 cannot meet tests/test_kernels.py's bars."""
    log_prior, Wn, b, c = (t.to(dtype) for t in (log_prior, Wn, b, c))
    y = x.to(dtype)[:, :, None, :]                                # (N,T,1,D)
    if shift is not None:
        y = y - shift.to(dtype)[:, None]                          # (N,T,K,D)
    quad = torch.einsum("ntkd,nkde,ntke->ntk", y.expand(-1, -1, Wn.shape[1],
                                                        -1), Wn, y)
    cross = (y * b[:, None]).sum(-1)
    log_rho = log_prior[:, None, :] - 0.5 * (quad - 2.0 * cross
                                             + c[:, None, :])
    r = torch.softmax(log_rho, dim=-1) * mask.to(dtype)[..., None]
    ry = r[..., None] * y                                         # (N,T,K,D)
    R = ordered_sum(r, dim=1) * replication
    sum_x = ordered_sum(ry, dim=1) * replication
    sum_xx = ordered_sum(ry[..., None] * y[..., None, :], dim=1) * replication
    return (r if return_r else None), R, sum_x, sum_xx


def gmm_estep_plain(x, mask, log_prior, Wn, b, c):
    """Single-node view of `gmm_estep_nodes_plain`."""
    r, R, sum_x, sum_xx = gmm_estep_nodes_plain(
        x[None], mask[None], log_prior[None], Wn[None], b[None], c[None])
    return r[0], R[0], sum_x[0], sum_xx[0]
