"""Every token trained in the window over the window's seconds (host clock;
the window ends in a synchronize)."""


def read(rec):
    return sum(u.tokens for u in rec.units if u.ok) / rec.window_s if rec.units else None
