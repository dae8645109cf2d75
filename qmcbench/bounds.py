"""The yardstick's arithmetic: the card's published peaks, the least time
each hand-written kernel of a molecular Slater-Jastrow step could take, and
the floating-point operations of one walker-step.

Counted from the configuration's shapes (the system file parsed by the
reference), so the count is the same whatever implements the step.

Kernel bounds: bytes are every input read once and every output written
once (per-walker state rows, random streams, per-walker results, and the
constant tables: orbital and Jastrow coefficients, basis, ECP); operations
are the floating-point operations of the kernels' arithmetic (an add,
multiply, divide, compare-and-select, sqrt, exp or log counts one; a
multiply-add two) for the primitives, channels and bases of the system.
Work that depends on the data is counted from the run: accepted moves do
the Sherman-Morrison and cache update; T-moves are counted as if none were
accepted, so their bound errs low.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores, data sheet

_BASIS_OPS = {("polypade", False): 12, ("polypade", True): 22,
              ("cutoffcusp", False): 15, ("cutoffcusp", True): 20}
_LEGENDRE_OPS = {0: 0, 1: 0, 2: 3, 3: 5, 4: 7, 5: 10, 6: 12}


class Shapes:
    """The counts of a Slater-Jastrow system: from the reference's parsed
    system (`reference.molecule_sj.load_system`, or `crystal_sj.load_crystal`
    with the replicated shells of its Bloch orbitals in `shells`) and the
    configuration's Jastrow bases and ECP quadrature."""

    def __init__(self, system, config):
        self.nup, self.ndn = system["nelec"]
        self.nelec = self.nup + self.ndn
        self.natom = len(system["symbols"])
        self.nselect = config["ecp"].get("nselect")
        self.shells = [(l, int((c != 0).sum())) for _, l, _, c in system["shells"]]
        self.nao = sum(2 * l + 1 for l, _ in self.shells)
        self.ei = [b[0] for b in config["jastrow"]["ei_basis"]]
        self.ee = [b[0] for b in config["jastrow"]["ee_basis"]]
        naip = config["ecp"]["quadrature_points"]
        self.nl_atoms = []  # per nonlocal atom: (naip, [(l, powers)])
        self.ecp_terms = 0
        for s in system["symbols"]:
            channels = system["ecp"].get(s, [0, []])[1]
            nl = [(l, [p for p, terms in enumerate(slots) for _ in terms])
                  for l, slots in channels if l >= 0]
            self.ecp_terms += sum(len(t) for _, slots in channels for t in slots)
            if nl:
                self.nl_atoms.append((naip, nl))
        self.nq = sum(n for n, _ in self.nl_atoms)
        self.periodic = "lattice" in system

    def table_bytes(self, itemsize):
        nprim = sum(p for _, p in self.shells)
        words = (self.nao * self.nelec + 2 * nprim + 4 * len(self.shells) + 4 * self.natom
                 + 2 * self.natom * len(self.ei) + 3 * len(self.ee) + 3 * self.ecp_terms
                 + 4 * self.nq)
        return words * itemsize

    def ao_ops(self, grad, sink_per_row, lap=False):
        """One point's AO values (and gradients, and laplacians) with
        `sink_per_row` operations per AO to use them."""
        total = 0
        for l, prims in self.shells:
            nc, ns = (l + 1) * (l + 2) // 2, 2 * l + 1
            comps = [(i, j, l - i - j) for i in range(l, -1, -1) for j in range(l - i, -1, -1)]
            nonzero = sum(1 for c in comps for x in c if x > 0)
            ops = 8 + prims * (6 if grad else 4) + 3 * l + 3 * nc + 2 * nc * ns
            if grad:
                ops += 5 * nc + 5 * nonzero + 6 * nc * ns
            if lap:
                ops += 2 * prims + 6 * nc + 2 * nc * ns
            total += ops + ns * sink_per_row
        return total

    def jastrow_ops(self, grad):
        per_term = 2 + (7 if grad else 0)
        a = sum(_BASIS_OPS[(k, grad)] + per_term for k in self.ei)
        b = sum(_BASIS_OPS[(k, grad)] + per_term for k in self.ee)
        return self.natom * (9 + a) + (self.nelec - 1) * (9 + b)

    def quad_ops(self, per_point):
        total = 0
        for naip, chans in self.nl_atoms:
            total += 9 + sum(2 + sum(6 + abs(p - 2) for p in powers) for _, powers in chans)
            total += naip * (15 + 6 + 6 + 1 + sum(_LEGENDRE_OPS[l] + 2 for l, _ in chans)
                             + per_point)
        return total

    def shell_ops(self, mode):
        """One point's AO evaluation in the periodic kernels (mode 0
        values, 1 with gradients, 2 with laplacians)."""
        total = 0
        for l, prims in self.shells:
            nc, ns = (l + 1) * (l + 2) // 2, 2 * l + 1
            comps = [(i, j, l - i - j) for i in range(l, -1, -1) for j in range(l - i, -1, -1)]
            nonzero = sum(1 for c in comps for x in c if x > 0)
            ops = 8 + prims * (4 + 2 * mode) + 3 * l + 3 * nc + 2 * nc * ns
            if mode >= 1:
                ops += 5 * nc + 5 * nonzero + 6 * nc * ns
            if mode >= 2:
                ops += 8 * nc + 6 * nonzero + 2 * nc * ns
            total += ops
        return total

    def update_ops(self):
        n = max(self.nup, self.ndn)
        return 2 * n * n + n * (3 * (n - 1) + 1) + 4 + 1


def kernel_bounds(shapes, nconf, accepted, itemsize=4):
    """{kernel: (bytes, operations)} of one launch at `nconf` walkers;
    `accepted` {kernel: accepted moves in a launch}."""
    s = shapes
    nup, ndn, nelec, n = s.nup, s.ndn, s.nelec, max(s.nup, s.ndn)
    rows = 3 * nelec + nup * nup + ndn * ndn + 4 + 4 * nup * nup + 4 * ndn * ndn + 1
    tab = s.table_bytes(itemsize)
    out = {}
    for name, dmc in (("vmc_sweep", False), ("dmc_sweep", True)):
        move = (8 * n + 3 + 2 * (s.jastrow_ops(True) + 3) + 2 * (14 if dmc else 10) + 6
                + s.ao_ops(True, 8 * n) + 8 * n + 3 + 3 + 3 + 5 + 9 + 5 + 4 + 2 + 1
                + (13 if dmc else 0))
        ops = nconf * nelec * move + accepted.get(name, 0) * s.update_ops()
        rows_io = 2 * rows + 3 * nelec + nelec + (3 if dmc else 1)
        out[name] = (rows_io * nconf * itemsize + tab, ops)
    point = s.ao_ops(False, 2) + s.jastrow_ops(False) + 3 + 2
    per_electron = 2 * s.nao * n + s.jastrow_ops(False) + s.quad_ops(point) + 1
    out["ecp_energy"] = ((3 * nelec + nup * nup + ndn * ndn + 9 * nelec + 1) * nconf * itemsize
                         + tab, nconf * nelec * per_electron)
    point = s.ao_ops(False, 2 * n) + 2 * n + s.jastrow_ops(False) + 3 + 1 + 3
    per_electron = s.jastrow_ops(False) + s.quad_ops(point) + 1 + 1 + 5 * s.nq
    moved = (5 * s.nq + 3 + 9 + 21 + s.jastrow_ops(False) + s.ao_ops(True, 8 * n)
             + s.update_ops() + 2)
    out["tmove_sweep"] = ((2 * rows + 9 * nelec + 2 * nelec) * nconf * itemsize + tab,
                          nconf * nelec * per_electron + accepted.get("tmove_sweep", 0) * moved)
    return out


def pbc_kernel_bounds(shapes, nconf, accepted, itemsize=4):
    """{kernel: (bytes, operations)} of one launch of the periodic sweep
    (K7, vmc_sweep and dmc_sweep) at `nconf` walkers."""
    s = shapes
    nup, ndn, nelec, n, nao = s.nup, s.ndn, s.nelec, max(s.nup, s.ndn), s.nao
    basis_ops = {"polypade": 22, "cutoffcusp": 20}
    jas = (s.natom * (18 + sum(basis_ops[k] + 9 for k in s.ei))
           + (nelec - 1) * (18 + sum(basis_ops[k] + 9 for k in s.ee)))
    move = (8 * n + 2 * jas + 2 * 10 + 27 * 4 + 9 + n * (5 + s.shell_ops(1) / n + 8 * nao)
            + 8 * n + 30)
    update = 2 * n * n + 3 * n * n + 4 * n + 6
    rows = 3 * nelec + nup * nup + ndn * ndn + 4 + 4 * nup * nup + 4 * ndn * ndn + 1
    tab = s.table_bytes(itemsize)
    out = {}
    for name, dmc in (("vmc_sweep", False), ("dmc_sweep", True)):
        extra = 2 * (15 - 10) + 1 + 11 + 2 if dmc else 0
        out[name] = ((2 * rows + 7 * nelec + (3 if dmc else 1)) * nconf * itemsize
                     + nao * nelec * itemsize + tab,
                     int(nconf * nelec * (move + extra) + accepted.get(name, 0) * update))
    return out


def value_mo_bound(shapes, m, ncol, itemsize=4):
    """(bytes, operations) of orbital values (K3) at m points and ncol
    columns: the points, the output and the coefficients read or written
    once, the tables; the AO evaluation and the contraction."""
    nbytes = (3 + ncol) * m * itemsize + shapes.nao * ncol * itemsize + shapes.table_bytes(itemsize)
    return nbytes, m * (shapes.shell_ops(0) + 2 * shapes.nao * ncol)


def bound_seconds(nbytes, ops):
    """The least seconds the card could take for (bytes, operations)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def walker_step_flops(shapes, dmc, acceptance):
    """Floating-point operations of one walker-step: the sweep's proposals
    (orbitals with gradients and the Jastrow at the old and new positions,
    the ratio and drift), the accepted moves' updates, the local energy
    (orbitals with gradients and laplacians at every electron, the
    determinants' derivative contractions, the Jastrow's, the Coulomb
    pairs, the nonlocal ECP's ratios at every quadrature point) and, in
    DMC, the T-moves' quadrature ratios."""
    s = shapes
    n, nelec = max(s.nup, s.ndn), s.nelec
    mo_grad = 2 * s.nao * n * 4  # values and gradients of n orbitals
    mo_lap = 2 * s.nao * n * 5
    sweep = nelec * (2 * (s.ao_ops(True, 0) + mo_grad + s.jastrow_ops(True) + 2 * n * 4) + 40)
    sweep += acceptance * nelec * s.update_ops()
    ratio_point = s.ao_ops(False, 0) + 2 * s.nao * n + 2 * n + s.jastrow_ops(False)
    kinetic = nelec * (s.ao_ops(True, 0, lap=True) + mo_lap + 2 * n * 5
                       + s.jastrow_ops(True) + 10)
    coulomb = 8 * nelec * (nelec - 1) // 2 + 8 * nelec * s.natom
    if s.nselect is not None and s.nselect < s.nq:  # ratios at the selected points only
        ecp = nelec * (s.quad_ops(0) + s.nselect * ratio_point + s.natom * 10)
    else:
        ecp = nelec * (s.quad_ops(ratio_point) + s.natom * 10)
    total = sweep + kinetic + coulomb + ecp
    if dmc:
        total += nelec * s.quad_ops(ratio_point)
    return total


def kernel_roofline(ctx, patterns, kernel):
    """A traced window's share (%) of the least time of a kernel's
    launches: 100 x launches x bound / their device seconds, the launches
    being the device events whose names hold any of `patterns`; `kernel`
    the kernel_bounds entry. None where none ran."""
    launches, seconds = ctx["summary"].kernel(patterns)
    if launches == 0 or seconds <= 0:
        return None
    traffic, shapes = ctx["cell"].traffic, ctx["shapes"]
    acceptance = sum(b["acceptance"] for b in ctx["blocks"]) / len(ctx["blocks"])
    accepted = {kernel: acceptance * traffic["nconf"] * shapes.nelec}
    table = pbc_kernel_bounds if shapes.periodic else kernel_bounds
    nbytes, ops = table(shapes, traffic["nconf"], accepted)[kernel]
    return 100.0 * launches * bound_seconds(nbytes, ops) / seconds
