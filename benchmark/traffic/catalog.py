"""A consistent-trees halo catalog (an ``hlist``), written from a seed.

The columns are the 60 of the consistent-trees hlist format, ``scale(0)``
to ``Halfmass_Radius(59)`` (``HEADER``), each printed as consistent-trees
prints it: scale factors, positions, spins, shapes and offsets ``%.5f``;
radii and circular velocities ``%f``; peculiar velocities ``%.3f``;
masses ``%.5e``; angular momenta ``%.3e``; IDs and flags ``%d``.

The model: a halo of ``n`` particles has the mass ``n * Mp``, with ``n``
drawn from the power law ``N(>n) ~ n**-slope`` between the smallest halo
Rockstar writes and ``max_mass``: the halo mass function's low-mass
slope, so that most rows lie near or under the mass cut.  Radii,
concentrations, circular velocities, angular momenta and the other mass
definitions follow the mass by scaling relations with log-normal scatter
(``_columns``); positions are uniform in the box, velocities Gaussian; a
share of the halos are subhalos, whose ``pid`` and ``upid`` name a
random halo.  All draws come from one ``torch.Generator`` seeded with the
run's seed, a chunk of rows at a time.

The text is printed on ``device`` (the card, in a run): each field's
digits come from integer arithmetic on the whole column, into one byte
matrix with its padding marked, and a chunk's kept bytes are copied to
the host and appended to the file.  The printed decimals are the
catalog's values.
"""

from __future__ import annotations

import math
import os
import re

import torch

HEADER = (
    "scale(0) id(1) desc_scale(2) desc_id(3) num_prog(4) pid(5) upid(6) "
    "desc_pid(7) phantom(8) sam_mvir(9) mvir(10) rvir(11) rs(12) vrms(13) "
    "mmp?(14) scale_of_last_MM(15) vmax(16) x(17) y(18) z(19) vx(20) "
    "vy(21) vz(22) Jx(23) Jy(24) Jz(25) Spin(26) Breadth_first_ID(27) "
    "Depth_first_ID(28) Tree_root_ID(29) Orig_halo_ID(30) Snap_num(31) "
    "Next_coprogenitor_depthfirst_ID(32) Last_progenitor_depthfirst_ID(33) "
    "Last_mainleaf_depthfirst_ID(34) Tidal_Force(35) Tidal_ID(36) "
    "Rs_Klypin(37) Mmvir_all(38) M200b(39) M200c(40) M500c(41) M2500c(42) "
    "Xoff(43) Voff(44) Spin_Bullock(45) b_to_a(46) c_to_a(47) A[x](48) "
    "A[y](49) A[z](50) b_to_a(500c)(51) c_to_a(500c)(52) A[x](500c)(53) "
    "A[y](500c)(54) A[z](500c)(55) T/|U|(56) M_pe_Behroozi(57) "
    "M_pe_Diemer(58) Halfmass_Radius(59)")
NAMES = [re.sub(r"\(\d+\)$", "", t) for t in HEADER.split()]
UNITS = ("#Units: Masses in Msun / h\n"
         "#Units: Positions in Mpc / h (comoving)\n"
         "#Units: Velocities in km / s (physical, peculiar)\n"
         "#Units: Halo Distances, Lengths, and Radii in kpc / h (comoving)\n"
         "#Units: Angular Momenta in (Msun/h) * (Mpc/h) * km/s (physical)\n"
         "#Units: Spins are dimensionless\n")
CHUNK = 1 << 17  # rows printed at a time


def _weights(count: int, device):
    return 10 ** torch.arange(count - 1, -1, -1, device=device,
                              dtype=torch.int64)


def _digits(a, count: int):
    """(rows, count) ASCII digits of the non-negative int64 ``a``."""
    return (a[:, None] // _weights(count, a.device) % 10 + 48).to(
        torch.uint8)


def _const(rows: int, ch: str, device):
    return (torch.full((rows, 1), ord(ch), dtype=torch.uint8, device=device),
            torch.ones((rows, 1), dtype=torch.bool, device=device))


def fixed(units, decimals: int):
    """The decimal ``units / 10**decimals`` as ``%.<decimals>f`` prints it
    (``%d`` for no decimals): ``(chars, keep)``, byte columns and which
    of them print."""
    a = units.abs()
    rows = len(a)
    int_digits = len(str(int(a.max()) // 10 ** decimals)) if rows else 1
    count = int_digits + decimals
    d = _digits(a, count)
    lead = a[:, None] >= _weights(count, a.device)[None, :int_digits - 1]
    sign = _const(rows, "-", a.device)[0]
    chars = [sign, d[:, :int_digits]]
    keep = [(units < 0)[:, None], lead,
            torch.ones((rows, 1), dtype=torch.bool, device=a.device)]
    if decimals:
        chars += [_const(rows, ".", a.device)[0], d[:, int_digits:]]
        keep.append(torch.ones((rows, 1 + decimals), dtype=torch.bool,
                               device=a.device))
    return torch.cat(chars, 1), torch.cat(keep, 1)


def scientific(mantissa, exponent, decimals: int, negative=None):
    """``m * 10**(e - decimals)`` as ``%.<decimals>e`` prints it, ``m`` of
    ``decimals + 1`` digits, ``|e| < 100``: ``(chars, keep)``."""
    dev = mantissa.device
    rows = len(mantissa)
    m = _digits(mantissa, decimals + 1)
    e = _digits(exponent.abs(), 2)
    esign = torch.where(exponent < 0, ord("-"), ord("+")).to(torch.uint8)
    col = lambda c: _const(rows, c, dev)[0]  # noqa: E731
    chars = torch.cat([col("-"), m[:, :1], col("."), m[:, 1:], col("e"),
                       esign[:, None], e], 1)
    keep = torch.ones(chars.shape, dtype=torch.bool, device=dev)
    keep[:, 0] = False if negative is None else negative
    return chars, keep


def to_fixed(x, decimals: int):
    """``x`` rounded to ``decimals`` places, as ``fixed`` takes it."""
    return torch.round(x * 10.0 ** decimals).to(torch.int64)


def to_scientific(x, decimals: int):
    """``x`` (no zeros) as ``scientific`` takes it:
    ``(mantissa, exponent, negative)``."""
    a = x.abs()
    e = torch.floor(torch.log10(a))
    m = torch.round(a * torch.pow(10.0, decimals - e))
    over = m >= 10.0 ** (decimals + 1)  # log10 a hair under a power of 10
    e = e + over.to(e.dtype)
    m = torch.where(over, torch.round(a * torch.pow(10.0, decimals - e)), m)
    under = m < 10.0 ** decimals
    e = e - under.to(e.dtype)
    m = torch.where(under, torch.round(a * torch.pow(10.0, decimals - e)), m)
    return m.to(torch.int64), e.to(torch.int64), x < 0


def text(fields):
    """Rows of ``(chars, keep)`` fields, space-separated and
    newline-ended: the kept bytes, as one uint8 tensor."""
    rows, dev = fields[0][0].shape[0], fields[0][0].device
    parts = [fields[0]]
    for f in fields[1:]:
        parts += [_const(rows, " ", dev), f]
    parts.append(_const(rows, "\n", dev))
    chars = torch.cat([p[0] for p in parts], 1)
    keep = torch.cat([p[1] for p in parts], 1)
    return chars[keep]


class _Draws:
    """Draws for ``rows`` rows from the run's generator, on its device."""

    def __init__(self, gen, rows: int):
        self.gen, self.rows, self.dev = gen, rows, gen.device

    def uniform(self, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(
            self.rows, generator=self.gen, device=self.dev,
            dtype=torch.float64)

    def normal(self):
        return torch.randn(self.rows, generator=self.gen, device=self.dev,
                           dtype=torch.float64)

    def scatter(self, dex: float, mean: float = 0.0):
        """A log-normal factor, ``mean`` and ``dex`` in dex."""
        return 10.0 ** (mean + dex * self.normal())

    def ints(self, lo: int, hi: int):
        return torch.randint(lo, hi, (self.rows,), generator=self.gen,
                             device=self.dev, dtype=torch.int64)

    def const(self, v):
        dtype = torch.int64 if isinstance(v, int) else torch.float64
        return torch.full((self.rows,), v, device=self.dev, dtype=dtype)


def _columns(r: _Draws, cfg: dict, first: int) -> list:
    """``[(format, values)]`` in ``HEADER``'s order for the rows from
    ``first``: formats ``d``, ``f<decimals>``, ``e<decimals>``."""
    g = cfg["catalog"]
    mf = g["mass_function"]
    rows_all = cfg["rows"]
    lo, hi, a = mf["min_particles"], mf["max_mass"] / cfg["Mp"], mf["slope"]
    n = torch.floor(lo * (1 - r.uniform() * (1 - (hi / lo) ** -a))
                    ** (-1.0 / a))
    mass = n * cfg["Mp"]
    lm = torch.log10(mass / 1e12)
    rho = 2.775e11 * g["omega_m"]
    rvir = 1000 * (3 * mass / (4 * math.pi * g["delta_vir"] * rho)) ** (1 / 3)
    rs = rvir / 10.0 ** (1 - 0.1 * lm + 0.13 * r.normal())
    vmax = 10.0 ** (2.2 + lm / 3 + 0.05 * r.normal())
    ids = g["id0"] + first + torch.arange(r.rows, device=r.dev)
    pid = torch.where(r.uniform() < g["subhalo_fraction"],
                      g["id0"] + r.ints(0, rows_all), -1)
    L = cfg["L"]
    pos = [r.ints(0, int(round(L * 1e5))) for _ in range(3)]
    vel = [to_fixed(torch.clamp(r.normal() * g["velocity_sigma"], -9999,
                                9999), 3) for _ in range(3)]
    jmag = mass * 10.0 ** (0.2 + 2 * lm / 3)
    spin = lambda: 0.035 * r.scatter(0.22)  # noqa: E731
    tree_id = lambda: r.ints(0, 10 ** 10)  # noqa: E731

    def shape(scale):
        b = r.uniform(0.4, 1.0)
        return [("f5", b), ("f5", b * r.uniform(0.5, 1.0))] + [
            ("f5", scale * rvir * r.normal() / math.sqrt(3))
            for _ in range(3)]

    return ([("f5", r.const(1.0)), ("d", ids), ("f5", r.const(0.0)),
             ("d", r.const(-1)), ("d", r.ints(0, g["max_progenitors"] + 1)),
             ("d", pid), ("d", pid), ("d", r.const(-1)), ("d", r.const(0)),
             ("e5", mass * r.scatter(0.02)), ("e5", mass), ("f6", rvir),
             ("f6", rs), ("f6", vmax * r.scatter(0.04, -0.05)),
             ("d", (r.uniform() < 0.9).to(torch.int64)),
             ("f5", r.uniform(0.05, 1.0)), ("f6", vmax)]
            + [("u5", p) for p in pos] + [("u3", v) for v in vel]
            + [("e3", jmag * r.scatter(0.3) * torch.sign(r.normal()))
               for _ in range(3)]
            + [("f5", spin()), ("d", tree_id()), ("d", tree_id()),
               ("d", ids), ("d", r.ints(0, 7 * rows_all)),
               ("d", r.const(g["snap_num"])), ("d", r.const(-1)),
               ("d", tree_id()), ("d", tree_id()),
               ("f5", 10.0 ** (-0.5 + 0.5 * r.normal())),
               ("d", torch.where(r.uniform() < 0.7,
                                 g["id0"] + r.ints(0, rows_all), -1)),
               ("f6", rs * r.scatter(0.05)),
               ("e5", mass * 10.0 ** (0.02 * r.normal().abs())),
               ("e5", mass * r.scatter(0.02, 0.04)),
               ("e5", mass * r.scatter(0.03, -0.1)),
               ("e5", mass * r.scatter(0.04, -0.25)),
               ("e5", mass * r.scatter(0.06, -0.6)),
               ("f5", rvir * r.scatter(0.3, -1.3)),
               ("f5", vmax * r.scatter(0.3, -1.3)),
               ("f5", 0.03 * r.scatter(0.22))]
            + shape(1.0) + shape(0.6)
            + [("f5", r.uniform(0.5, 0.8)), ("e5", mass * r.scatter(0.03)),
               ("e5", mass * r.scatter(0.03)),
               ("f6", rvir * r.scatter(0.1, -0.3))])


def _field(fmt: str, x):
    kind, decimals = fmt[0], int(fmt[1:] or 0)
    if kind == "d":
        return fixed(x, 0)
    if kind == "u":  # already in units of the last decimal
        return fixed(x, decimals)
    if kind == "f":
        return fixed(to_fixed(x, decimals), decimals)
    m, e, negative = to_scientific(x, decimals)
    return scientific(m, e, decimals, negative)


def rows_text(cfg: dict, gen, first: int, rows: int):
    """The text of rows ``first .. first + rows``, as one uint8 tensor on
    the generator's device."""
    cols = _columns(_Draws(gen, rows), cfg, first)
    assert len(cols) == len(NAMES)
    return text([_field(fmt, x) for fmt, x in cols])


def write(directory: str, cfg: dict, seed: int, device="cpu") -> str:
    """Write the catalog ``hlist_1.00000.list`` and the converter's config,
    name index, type index and list of stored columns (``vars.txt``) into
    ``directory``; returns the catalog's path.  ``cfg`` is the
    deployment's configuration; the text is printed on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    hlist = os.path.join(directory, "hlist_1.00000.list")
    g = cfg["catalog"]
    with open(hlist, "wb") as f:
        f.write(("#%s\n#a = 1.00000\n#Omega_M = %.6f\n"
                 "#Full box size = %.6f Mpc/h\n%s"
                 "#Synthetic catalog (the benchmark's model), seed %d\n"
                 % (HEADER, g["omega_m"], cfg["L"], UNITS, seed)).encode())
        for first in range(0, cfg["rows"], CHUNK):
            rows = min(CHUNK, cfg["rows"] - first)
            f.write(rows_text(cfg, gen, first, rows).cpu().numpy())
    stored = {n for names in cfg["names"] for n in names}
    with open(os.path.join(directory, "names.txt"), "w") as f:
        f.write("".join(" ".join(n) + "\n" for n in cfg["names"]))
        f.write("".join(n + "\n" for n in NAMES if n not in stored))
    with open(os.path.join(directory, "types.txt"), "w") as f:
        f.write("".join("%s %s\n" % (n, " ".join(t))
                        for n, t in cfg["types"].items()))
    with open(os.path.join(directory, "vars.txt"), "w") as f:
        f.write("".join(n + "\n" for n in cfg["types"]))
    with open(os.path.join(directory, "run.config"), "w") as f:
        f.write("[minh]\nL = %r\nEpsilon = %r\nMp = %r\nMinParticles = %d\n"
                "MassName = %s\nNameIndex = %s\nTypeIndex = %s\n"
                % (cfg["L"], cfg["epsilon"], cfg["Mp"],
                   cfg["min_particles"], cfg["mass_name"],
                   os.path.join(directory, "names.txt"),
                   os.path.join(directory, "types.txt")))
    return hlist
