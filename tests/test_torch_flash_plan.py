"""The flash kernel's split plan (``flash_attention.flash_plan``) and its
merge of partials, on the CPU.

The CUDA flash kernel hands each block a work item: one 64-row query tile
and a chunk of its 32-key tiles.  A query tile of several chunks leaves one
partial (acc, m, l) per chunk, and a second kernel merges them in chunk
order.  The plan is chosen in Python from the shapes alone, so it is held
here: at TinyLlama-1.1B's and Gemma3-1B's eval shapes and at the ragged
shapes of the card's flash tests, every visible (query, key) pair lies in
exactly one item, a row that sees no key has every key once, no item is
wholly masked unless its query tile holds such a row, and the item counts
and sizes are as designed.  Then the merge, emulated in plain torch f32 in
the plan's order (the kernel's masks: -1e30 for a masked score, nothing
past Skv), equals ``ref.flash_attention_ref`` within 1e-6.  The kernels
themselves run only on the card (``test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

NEG = -1e30
#: (B, Sq, Skv, H, KV, hd, causal, window) of the eval forward
TINYLLAMA = (4, 256, 256, 32, 4, 64, True, 0)
GEMMA3_GLOBAL = (2, 1024, 1024, 4, 1, 256, True, 0)
GEMMA3_WINDOW = (2, 1024, 1024, 4, 1, 256, True, 512)
#: the card's flash cases off the eval shapes: ragged lengths, odd hd, rows
#: that see no key, Sq != Skv, and shapes whose own plan splits
RAGGED = [(2, 128, 128, 4, 1, 64, False, 0), (1, 192, 192, 6, 3, 32, True, 0),
          (1, 256, 256, 8, 8, 16, True, 64), (1, 70, 90, 4, 2, 40, True, 20),
          (1, 100, 30, 4, 2, 32, True, 8), (1, 128, 128, 4, 2, 32, True, 0),
          (2, 256, 256, 4, 1, 256, True, 64), (1, 192, 192, 8, 2, 64, True, 0),
          (1, 320, 200, 4, 2, 64, True, 0), (1, 100, 300, 4, 1, 128, False, 0),
          (1, 600, 300, 4, 2, 32, True, 16)]
SHAPES = [TINYLLAMA, GEMMA3_GLOBAL, GEMMA3_WINDOW] + RAGGED


def _visible(Sq, Skv, causal, window):
    q = torch.arange(Sq)[:, None]
    k = torch.arange(Skv)[None, :]
    ok = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        ok &= k <= q
    if window > 0:
        ok &= k > q - window
    return ok


def _chunks(shape):
    """The plan's chunk, and the finest split (one key tile an item)."""
    B, Sq, Skv, H, _, _, causal, window = shape
    return sorted({fa.flash_plan(B, H, Sq, Skv, causal, window)[0], 1})


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_visible_pair_once(shape):
    B, Sq, Skv, H, KV, hd, causal, window = shape
    vis = _visible(Sq, Skv, causal, window)
    blind = ~vis.any(dim=1)                    # rows that see no key
    for chunk in _chunks(shape):
        count = torch.zeros(Sq, Skv, dtype=torch.int32)
        for qt, t0, t1, n in fa.plan_items(Sq, Skv, causal, window, chunk):
            assert 1 <= t1 - t0 <= chunk and n >= 1
            rows = slice(qt * fa.BLOCK_Q, min((qt + 1) * fa.BLOCK_Q, Sq))
            keys = slice(t0 * fa.BLOCK_KV, min(t1 * fa.BLOCK_KV, Skv))
            assert keys.start < keys.stop
            count[rows, keys] += 1
            if not bool(blind[rows].any()):
                assert bool(vis[rows, keys].any()), f"item {(qt, t0, t1)} is wholly masked"
        assert bool((count <= 1).all())
        assert bool((count[vis] == 1).all())
        assert bool((count[blind] == 1).all())


def test_plan_sizes_are_as_designed():
    """TinyLlama's eval (4 resident blocks an SM) does not split; Gemma3-1B's
    global and window-512 layers (one block an SM at hd 256) put about
    three items on each of the 132 SMs, none over 8 key tiles (256 keys)."""
    def items(shape):
        B, Sq, Skv, H, _, _, causal, window = shape
        chunk, nc = fa.flash_plan(B, H, Sq, Skv, causal, window)
        its = fa.plan_items(Sq, Skv, causal, window, chunk)
        assert max(n for *_, n in its) == nc
        assert nc == 1 or chunk >= fa.MIN_CHUNK
        return chunk, nc, len(its) * B * H, max(t1 - t0 for _, t0, t1, _ in its)

    assert items(TINYLLAMA) == (8, 1, 512, 8)
    assert items(GEMMA3_GLOBAL) == (7, 5, 368, 7)
    assert items(GEMMA3_WINDOW) == (5, 4, 400, 5)
    for shape in (GEMMA3_GLOBAL, GEMMA3_WINDOW):
        chunk, nc, n_items, largest = items(shape)
        assert 2 * fa.SMS <= n_items <= 4 * fa.SMS and largest <= 8


def _split_attention(q, k, v, causal, window, chunk):
    """The kernel's algorithm in plain torch f32: per work item the partial
    (acc, m, l) of its keys (m from -1e30, as the kernel's running max),
    then per query tile the merge in chunk order."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = hd ** -0.5
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s_all = torch.einsum("bqhd,bkhd->bhqk", qs, k.repeat_interleave(rep, dim=2)).float()
    s_all = torch.where(_visible(Sq, Skv, causal, window), s_all, torch.tensor(NEG))
    vr = v.repeat_interleave(rep, dim=2).float().transpose(1, 2)        # (B, H, Skv, hd)
    out = torch.empty(B, H, Sq, hd)
    parts = {}
    for qt, t0, t1, n in fa.plan_items(Sq, Skv, causal, window, chunk):
        rows = slice(qt * fa.BLOCK_Q, min((qt + 1) * fa.BLOCK_Q, Sq))
        keys = slice(t0 * fa.BLOCK_KV, min(t1 * fa.BLOCK_KV, Skv))
        s = s_all[:, :, rows, keys]
        m = torch.clamp(s.amax(dim=-1), min=NEG)
        p = torch.exp(s - m[..., None])
        parts.setdefault(qt, []).append((p @ vr[:, :, keys], m, p.sum(dim=-1)))
    for qt, chunks in parts.items():
        rows = slice(qt * fa.BLOCK_Q, min((qt + 1) * fa.BLOCK_Q, Sq))
        m = torch.stack([c[1] for c in chunks]).amax(dim=0)
        acc, l = torch.zeros_like(chunks[0][0]), torch.zeros_like(m)
        for a_c, m_c, l_c in chunks:              # chunk order
            w = torch.exp(m_c - m)
            acc = acc + w[..., None] * a_c
            l = l + w * l_c
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_split_merge_matches_reference(shape):
    B, Sq, Skv, H, KV, hd, causal, window = shape
    rng = np.random.default_rng(Sq + hd)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))
            for _ in range(2))
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    for chunk in _chunks(shape):
        got = _split_attention(q, k, v, causal, window, chunk)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
