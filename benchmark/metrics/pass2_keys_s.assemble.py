"""Host seconds of the graph build's pass-2 window keying per assembly:
span build/pass2/keys (the k-mer keys of pass 1's contigs, of each
contig marked visited, of the near-duplicate test and of the open-end
trim, every window keying of the sink codec in pass 2; at k > 31 the
four code words and the fingerprint of each window on the host), mean
over the window's assemblies but the profiled one. Part of
build_pass2_host_s. Moves device_peak_gib."""
from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_assembly(ctx, lambda t: t.get("build/pass2/keys"))
