"""Seconds per whole assembly, as run.assembly_s takes them: every
assembly of the traced run's window (the one in flight at the close
included), total over count, on the host's clock. The traced run
profiles its first assembly and closes each walk round with a
synchronize, so this reads somewhat above an untraced run. Moves
device_peak_gib."""


def read(ctx):
    return (ctx.get("window") or {}).get("assembly_s")
