"""The vectorised read generator (benchmark/gen.py)."""
import torch

from benchmark import gen

CFG = dict(genome_len=50_000, min_repeats=4, bp_per_repeat=250_000,
           data_seed=99, repeat_len=400, coverage=20.0, read_len=100,
           err_rate=0.01, batch_reads=1024)


def _truth(genome, reads):
    G, L = genome.shape[0], reads.bases.shape[1]
    idx = (reads.starts[:, None] + torch.arange(L)) % G
    return genome[idx]


def test_same_seed_same_inputs_other_seed_same_batches_reordered():
    seed = 2 ** 33 + 7  # more than 32 bits, as a check's seeds may be
    g1, r1 = gen.make(CFG, seed, "cpu")
    g2, r2 = gen.make(CFG, seed, "cpu")
    g3, r3 = gen.make(CFG, seed + 1, "cpu")
    assert torch.equal(g1, g2) and torch.equal(r1.bases, r2.bases)
    assert torch.equal(g1, g3) and not torch.equal(r1.bases, r3.bases)
    B = CFG["batch_reads"]
    for i in range(0, r1.n_reads, B):  # the same batches, reordered
        key = lambda r: sorted(zip(r.starts[i:i + B].tolist(),
                                   r.flipped[i:i + B].tolist(),
                                   map(bytes, r.bases[i:i + B].numpy())))
        assert key(r1) == key(r3)


def test_counts_lengths_and_padding():
    g, r = gen.make(CFG, 5, "cpu")
    n = int(CFG["coverage"] * CFG["genome_len"] / CFG["read_len"])
    assert r.n_reads == n
    assert r.bases.shape == (-(-n // 1024) * 1024, 100)
    assert (r.lens[:n] == 100).all() and (r.lens[n:] == 0).all()
    assert (r.bases[n:] == 4).all() and (r.bases[:n] < 4).all()
    assert g.shape == (CFG["genome_len"],) and (g < 4).all()


def test_planted_repeats():
    g, _ = gen.make(CFG, 5, "cpu")
    R, n = 400, 4
    chunk = (CFG["genome_len"] - n * R) // (n + 1)
    units = [g[i * (chunk + R) + chunk:][:R] for i in range(n)]
    assert all(torch.equal(units[0], u) for u in units[1:])


def test_strand_and_error_shares():
    g, r = gen.make(CFG, 9, "cpu")
    n = r.n_reads
    reads = r.bases[:n].clone()
    f = r.flipped
    reads[f] = 3 - reads[f].flip(1)  # back to the forward strand
    wrong = (reads != _truth(g, r)).float().mean().item()
    # a substitution draws one of the four bases: 3/4 of them change it
    assert abs(wrong - 0.75 * CFG["err_rate"]) < 0.0015
    assert abs(f.float().mean().item() - 0.5) < 0.02
