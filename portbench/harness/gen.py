"""The benchmark's own data and query generator, driven by `--seed`.

Vectors follow the repo's synthetic validation specs: Gaussian clusters
on a `latent_dim`-dimensional manifold embedded into `dim` ambient
dimensions, plus ambient noise. Labels blend a per-cluster preferred
pool (label-vector coupling) with global Zipf draws, `avg_labels` a row
on average (1 + Poisson). Queries follow the paper's §6.1.3: a base row
plus Gaussian noise at 10% of the median row norm; EQUALITY takes
another row's whole label set, AND 1-3 of its labels, OR 2-8 labels
drawn by label frequency.

Everything is drawn with `torch.Generator`s on the given device in a few
large calls, so a 1M-row dataset takes well under a second on a card.
It is not byte-identical to the repo's host generator; it draws the
same distributions. The same seed gives the same arrays on the same
kind of device. Bitmaps are int32 tensors holding uint32 words.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

PREDICATES = ("EQUALITY", "AND", "OR")


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed derived from `seed` and `tags` (any whole numbers
    or strings): independent streams for the data, the pool and the
    warm-up, whatever the size of `seed`."""
    h = hashlib.sha256(":".join(map(str, (int(seed),) + tags)).encode())
    return int.from_bytes(h.digest()[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


@dataclasses.dataclass(frozen=True)
class DataSpec:
    n: int
    dim: int
    universe: int
    latent_dim: int
    n_clusters: int
    zipf_a: float
    avg_labels: float
    coupling: float
    noise: float

    @staticmethod
    def from_config(cfg: dict) -> "DataSpec":
        d = cfg["data"]
        return DataSpec(**{f.name: d[f.name]
                           for f in dataclasses.fields(DataSpec)})

    @property
    def words(self) -> int:
        return max(1, (self.universe + 31) // 32)


# Label draws a row makes before it stops; a row that has not reached
# its label count by then keeps the labels it has (a row of 1 + Poisson
# labels meets duplicates mostly in its small preferred pool).
LABEL_DRAWS = 48


@dataclasses.dataclass
class Data:
    """One generated dataset on `device`, in the order it was drawn."""
    vectors: torch.Tensor        # [N, D] float32
    bitmaps: torch.Tensor        # [N, W] int32 views of uint32 words
    label_cdf: torch.Tensor      # [U] float64 CDF of label frequency
    median_norm: float
    universe: int


def _cdf(p: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(p.to(torch.float64), 0)
    return c / c[-1]


def _draw(cdf: torch.Tensor, shape, g) -> torch.Tensor:
    """Categorical draws by inverse CDF: int64 indices of `shape`."""
    u = torch.rand(shape, generator=g, device=cdf.device,
                   dtype=torch.float64)
    return torch.searchsorted(cdf, u.reshape(-1), right=True).clamp_(
        max=cdf.numel() - 1).reshape(shape)


def to_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 word values -> int32 tensor of the bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack(bitmaps: torch.Tensor, universe: int) -> torch.Tensor:
    """[R, W] int32 words -> [R, universe] bool membership."""
    shifts = torch.arange(32, device=bitmaps.device, dtype=torch.int32)
    bits = (bitmaps[:, :, None] >> shifts) & 1
    return bits.reshape(bitmaps.shape[0], -1)[:, :universe].bool()


def pack(members: torch.Tensor) -> torch.Tensor:
    """[R, U] bool membership -> [R, W] int32 words."""
    r, u = members.shape
    w = max(1, (u + 31) // 32)
    pad = torch.zeros((r, w * 32), dtype=torch.int64, device=members.device)
    pad[:, :u] = members.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=members.device) << \
        torch.arange(32, dtype=torch.int64, device=members.device)
    return to_int32_words((pad.reshape(r, w, 32) * weights).sum(-1))


def make_data(spec: DataSpec, seed: int, device) -> Data:
    """The dataset of `spec` drawn from `seed` on `device`."""
    device = torch.device(device)
    g = generator(device, seed, "data")
    n, d, m, c, u = (spec.n, spec.dim, spec.latent_dim, spec.n_clusters,
                     spec.universe)
    f32 = dict(device=device, dtype=torch.float32, generator=g)

    # vectors: latent Gaussian clusters embedded into the ambient space
    centers = torch.randn((c, m), **f32) * 4.0
    assign = torch.randint(0, c, (n,), device=device, generator=g)
    latent = centers[assign] + torch.randn((n, m), **f32)
    basis = torch.randn((m, d), **f32) / math.sqrt(m)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        vectors = latent @ basis
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    vectors += spec.noise * torch.randn((n, d), **f32)
    del latent

    # labels: a Zipf popularity decoupled from the label id, a preferred
    # pool per cluster drawn without replacement by popularity
    # (Gumbel top-k), then draws from the pool (share `coupling`) or the
    # whole universe until a row holds 1 + Poisson(avg - 1) labels
    pop = torch.arange(1, u + 1, device=device, dtype=torch.float64) ** (
        -spec.zipf_a)
    pop = pop[torch.argsort(torch.randperm(u, device=device, generator=g))]
    pop = pop / pop.sum()
    pref_size = max(1, min(u, math.ceil(u / c) + 2))
    gumbel = -torch.log(-torch.log(torch.rand(
        (c, u), device=device, dtype=torch.float64, generator=g)
        .clamp_(1e-300, 1.0 - 1e-16)))
    pref = torch.topk(torch.log(pop)[None, :] + gumbel, pref_size,
                      dim=1).indices                          # [C, P]
    lam = torch.full((n,), max(spec.avg_labels - 1.0, 0.0), device=device,
                     dtype=torch.float32)
    counts = (torch.poisson(lam, generator=g).to(torch.int64) + 1).clamp_(
        max=u)
    from_pref = torch.rand((n, LABEL_DRAWS), device=device,
                           generator=g) < spec.coupling
    slot = torch.randint(0, pref_size, (n, LABEL_DRAWS), device=device,
                         generator=g)
    pref_pick = pref[assign[:, None], slot]
    glob_pick = _draw(_cdf(pop), (n, LABEL_DRAWS), g)
    cand = torch.where(from_pref, pref_pick, glob_pick)
    del from_pref, slot, pref_pick, glob_pick

    words = torch.zeros((n, spec.words), dtype=torch.int64, device=device)
    have = torch.zeros(n, dtype=torch.int64, device=device)
    for j in range(LABEL_DRAWS):
        lab = cand[:, j]
        word = (lab >> 5)[:, None]
        bit = torch.ones_like(lab) << (lab & 31)
        cur = words.gather(1, word)[:, 0]
        new = ((cur & bit) == 0) & (have < counts)
        words.scatter_(1, word, (cur | torch.where(new, bit, 0))[:, None])
        have += new.to(torch.int64)
    bitmaps = to_int32_words(words)
    del words, cand

    freq = torch.zeros(u, device=device, dtype=torch.float64)
    for s in range(0, n, 1 << 18):
        freq += unpack(bitmaps[s:s + (1 << 18)], u).sum(0, dtype=torch.float64)
    median_norm = float(torch.linalg.vector_norm(vectors, dim=1).median())
    return Data(vectors=vectors, bitmaps=bitmaps, label_cdf=_cdf(freq),
                median_norm=median_norm, universe=u)


def make_queries(data: Data, pred: str, q: int, g: torch.Generator,
                 vectors=None, bitmaps=None):
    """`q` queries of predicate `pred` per §6.1.3, drawn with `g` on its
    device. `vectors`/`bitmaps` are the rows to draw from (the data's by
    default; a host copy of them gives the same queries). Returns
    ([q, D] float32, [q, W] int32) on `g`'s device."""
    dev = g.device
    vectors = data.vectors if vectors is None else vectors
    bitmaps = data.bitmaps if bitmaps is None else bitmaps
    n, d = vectors.shape
    base = torch.randint(0, n, (q,), device=dev, generator=g)
    src = torch.randint(0, n, (q,), device=dev, generator=g)
    noise = torch.randn((q, d), device=dev, generator=g)
    scale = 0.1 * data.median_norm / math.sqrt(d)
    qv = vectors[base.to(vectors.device)].to(dev) + scale * noise
    src_bm = bitmaps[src.to(bitmaps.device)].to(dev)
    if pred == "EQUALITY":
        return qv, src_bm
    u = data.universe
    if pred == "AND":
        # 1..min(3, |L|) distinct labels of the source row, uniformly
        mem = unpack(src_bm, u)
        size = mem.sum(1)
        take = (torch.rand(q, device=dev, generator=g)
                * size.clamp(max=3)).floor().to(torch.int64) + 1
        keys = torch.where(mem, torch.rand((q, u), device=dev, generator=g),
                           2.0)
        rank = torch.argsort(torch.argsort(keys, dim=1), dim=1)
        return qv, pack(mem & (rank < take[:, None]))
    if pred == "OR":
        # 2..8 draws by label frequency, with replacement
        take = torch.randint(2, 9, (q,), device=dev, generator=g)
        labs = _draw(data.label_cdf.to(dev), (q, 8), g)
        keep = torch.arange(8, device=dev)[None, :] < take[:, None]
        # the first draw is always kept: it stands in for the dropped ones
        mem = torch.zeros((q, u), dtype=torch.bool, device=dev)
        mem.scatter_(1, torch.where(keep, labs, labs[:, :1]), True)
        return qv, pack(mem)
    raise ValueError(f"unknown predicate {pred!r}")


class QueryPool:
    """The window's queries: batch `i` has predicate
    `predicates[i % len(predicates)]` and `batch` queries, drawn from the
    stream (seed, `stream`, chunk) in chunks of `chunk` batches, so a
    batch's queries do not depend on how far the pool was drawn ahead.
    Chunks are drawn on the data's device and kept on the host; a batch
    past the drawn ones draws its chunk then, with the same device
    generator over the host copy of the rows (the same queries)."""

    def __init__(self, data: Data, seed: int, stream: str, batch: int,
                 predicates, chunk: int = 32):
        self.data = data
        self.device = data.vectors.device
        self.seed = int(seed)
        self.stream = stream
        self.batch = int(batch)
        self.predicates = tuple(predicates)
        self.chunk = int(chunk)
        self._chunks: dict[int, tuple] = {}
        self._host_rows = None
        self.drawn_late = 0           # chunks drawn after `prepare`

    def pred(self, i: int) -> str:
        return self.predicates[i % len(self.predicates)]

    def _draw_chunk(self, c: int, on_host: bool):
        g = generator(self.device, self.seed, self.stream, c)
        kw = {}
        if on_host:
            kw = dict(vectors=self._host_rows[0], bitmaps=self._host_rows[1])
        vs, bs = [], []
        for i in range(c * self.chunk, (c + 1) * self.chunk):
            qv, qb = make_queries(self.data, self.pred(i), self.batch, g,
                                  **kw)
            vs.append(qv)
            bs.append(qb)
        # one copy to the host a chunk
        vs = list(torch.stack(vs).cpu().numpy())
        bs = list(torch.stack(bs).cpu().numpy().view(np.uint32))
        self._chunks[c] = (vs, bs)

    def prepare(self, n_batches: int) -> None:
        """Draw the chunks that cover the first `n_batches` batches, on
        the data's device."""
        for c in range(-(-int(n_batches) // self.chunk)):
            if c not in self._chunks:
                self._draw_chunk(c, on_host=False)

    def keep_host_rows(self, vectors: np.ndarray,
                       bitmaps: np.ndarray) -> None:
        """Host copies of the rows, for chunks drawn after the data's
        device copy is freed."""
        self._host_rows = (torch.from_numpy(vectors),
                           torch.from_numpy(bitmaps.view(np.int32)))

    def get(self, i: int) -> tuple[str, np.ndarray, np.ndarray]:
        """(predicate, [B, D] float32, [B, W] uint32) of batch `i`."""
        c = i // self.chunk
        if c not in self._chunks:
            self._draw_chunk(c, on_host=self._host_rows is not None)
            self.drawn_late += 1
        vs, bs = self._chunks[c]
        j = i - c * self.chunk
        return self.pred(i), vs[j], bs[j]
