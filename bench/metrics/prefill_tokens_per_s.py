"""Every prompt token prefilled in the window over the window's seconds (host
clock; each request ends with its first token on the host)."""


def read(rec):
    return sum(u.tokens for u in rec.units if u.ok) / rec.window_s if rec.units else None
