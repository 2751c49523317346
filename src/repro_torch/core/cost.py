"""Unit-gate structural cost model (hardware proxies for Tables 3-4).

The paper reports Synopsys 45 nm numbers; those are unobtainable without
the toolchain, so we use the standard unit-gate convention to reproduce
*orderings* and *relative* deltas:

  - 2-input AND/OR/NAND/NOR: area 1, delay 1, energy 1
  - XOR/XNOR:                area 2, delay 2, energy 2
  - inverter:                area 0.5, delay 0.5, energy 0.5
  - MUX2:                    area 2, delay 2, energy 2

Primitive cells are costed from the same gate structures as the
functional models in ``compressors.py``:

  HA  = XOR + AND                       -> area 3,  delay 2 (sum), 1 (carry)
  FA  = 2 XOR + 2 AND + OR              -> area 7,  delay 4 (sum), 3 (carry)
  4:2 = 2 FA chained                    -> area 14, delay: sum 6, carry 5, cout 3
  3,3:2 = 2 FA + HA + OR3               -> (paper Fig. 2(b))
  ...

Delay is a critical-path estimate per output; a multiplier's delay is the
max over product bits of its dataflow depth, computed over the same stage
plans used by the functional code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

# (area, energy) per primitive; delays handled structurally below.
GATE = {"and": (1.0, 1.0), "or": (1.0, 1.0), "xor": (2.0, 2.0),
        "not": (0.5, 0.5), "or3": (1.5, 1.5)}


@dataclass(frozen=True)
class CellCost:
    name: str
    area: float
    energy: float
    d_sum: float     # input -> sum delay
    d_carry: float   # input -> carry delay
    d_cout: float    # input -> cout delay (0 if none)


def _ha() -> CellCost:
    # sum = XOR (2), carry = AND (1)
    return CellCost("ha", 3.0, 3.0, 2.0, 1.0, 0.0)


def _fa() -> CellCost:
    # sum = 2 XOR chained (4); carry = maj via 2 AND + OR (3)
    return CellCost("fa", 7.0, 7.0, 4.0, 3.0, 0.0)


def _c42() -> CellCost:
    # two chained FAs: cout after first FA (3); sum 4+... = 8? Standard
    # implementation: sum delay = XOR of first FA (4) into second FA sum (4)
    # -> but x4/cin join at the 2nd FA, so worst path = 4 + 4 = 8 for sum,
    # 4 + 3 for carry, 3 for cout.
    return CellCost("4:2-exact", 14.0, 14.0, 8.0, 7.0, 3.0)


def _cell_332() -> CellCost:
    # Fig. 2(b): FA_a (sum sa 4, carry ca 3), FA_b (sb 4, cb 3),
    # HA(sa, cin): s = sa^cin -> 4+2 = 6; c_lo = sa&cin -> 4+1 = 5
    # carry = OR3(ca, c_lo, sb) -> max(3, 5, 4) + 1.5 = 6.5
    # cout = cb -> 3
    area = 7 + 7 + 3 + 1.5
    return CellCost("3,3:2", area, area, 6.0, 6.5, 3.0)


def _cell_222() -> CellCost:
    # HAs instead of FAs: sa 2, ca 1; HA(sa,cin): s 4, c_lo 3;
    # carry = OR3(ca, c_lo, sb) = 3 + 1.5 = 4.5; cout = cb = 1
    area = 3 + 3 + 3 + 1.5
    return CellCost("2,2:2", area, area, 4.0, 4.5, 1.0)


def _cell_332_nocin() -> CellCost:
    # no HA: s = sa (4), carry = OR(ca, sb) = 4+1 = 5, cout = cb (3)
    area = 7 + 7 + 1
    return CellCost("3,3:2-nocin", area, area, 4.0, 5.0, 3.0)


def _cell_322_nocin() -> CellCost:
    area = 3 + 7 + 1  # HA_a + FA_b + OR
    return CellCost("3,2:2-nocin", area, area, 2.0, 5.0, 3.0)


def _cell_232() -> CellCost:
    # FA_a + HA_b + HA(sa,cin) + OR3
    area = 7 + 3 + 3 + 1.5
    return CellCost("2,3:2", area, area, 6.0, 6.5, 1.0)


def _cell_132() -> CellCost:
    # FA_a + HA(sa,cin) + OR3(ca, c_lo, b1); no cout
    area = 7 + 3 + 1.5
    return CellCost("1,3:2", area, area, 6.0, 6.5, 0.0)


def _cell_122() -> CellCost:
    area = 3 + 3 + 1.5
    return CellCost("1,2:2", area, area, 4.0, 4.5, 0.0)


def _cell_122_nocin() -> CellCost:
    area = 3 + 1
    return CellCost("1,2:2-nocin", area, area, 2.0, 3.0, 0.0)


CELLS: Dict[str, CellCost] = {
    "ha": _ha(), "fa": _fa(), "4:2-exact": _c42(),
    "3,3:2": _cell_332(), "2,2:2": _cell_222(),
    "3,3:2-nocin": _cell_332_nocin(), "3,2:2-nocin": _cell_322_nocin(),
    "2,3:2": _cell_232(), "1,3:2": _cell_132(), "1,2:2": _cell_122(),
    "1,2:2-nocin": _cell_122_nocin(),
}

_STAGE1_OP_TO_CELL = {
    "33": "3,3:2-nocin", "33c": "3,3:2", "23": "2,3:2", "23c": "2,3:2",
    "32": "3,2:2-nocin", "22": "2,2:2", "22c": "2,2:2",
    "13": "1,3:2", "13c": "1,3:2", "12": "1,2:2-nocin", "12c": "1,2:2",
    "ha": "ha", "fa": "fa", "ha_h": "ha", "fa_h": "fa",
    "c42first": "4:2-exact", "c42": "4:2-exact", "c42_3": "4:2-exact",
}


def multiplier_cost(stage1_plan, cell_pairs, rca_from: int,
                    n_trunc: int = 0, drop_msb: bool = False) -> Dict[str, float]:
    """Structural cost of a two-stage proposed multiplier.

    Returns unit-gate area/energy, critical-path delay (unit-gate delays),
    stage count, AND-gate count for pp generation.
    """
    area = energy = 0.0
    # phase 1: AND gates for partial products (minus truncated columns)
    n_pp = sum(min(k + 1, 8, 15 - k) for k in range(n_trunc, 15))
    area += n_pp
    energy += n_pp
    d_pp = 1.0

    # stage 1
    s1_out_delay = d_pp
    for op, _k in stage1_plan:
        c = CELLS[_STAGE1_OP_TO_CELL[op]]
        area += c.area
        energy += c.energy
        s1_out_delay = max(s1_out_delay, d_pp + max(c.d_sum, c.d_carry, c.d_cout))

    # stage 2 cells
    cell = CELLS["3,3:2"]
    n_cells = len(cell_pairs)
    area += n_cells * cell.area
    energy += n_cells * cell.energy
    # cout->cin chain depth: cout is pp-direct (d_cout) then one cin->sum hop
    s2_cell_delay = s1_out_delay + max(cell.d_sum, cell.d_carry) + cell.d_cout

    # stage 2 adder (head FA+HA, then RCA): ~2 FAs per remaining column
    if not drop_msb:
        n_rca = 16 - rca_from
        fa = CELLS["fa"]
        area += n_rca * fa.area + CELLS["ha"].area  # head HA extra
        energy += n_rca * fa.energy + CELLS["ha"].energy
        rca_delay = s1_out_delay + 2.0 + n_rca * fa.d_carry  # head + ripple
    else:
        rca_delay = 0.0

    delay = max(s2_cell_delay, rca_delay)
    return {
        "area": area, "energy": energy, "delay": delay,
        "stages": 2, "pp_and_gates": float(n_pp),
    }


def dadda_cost() -> Dict[str, float]:
    """Dadda 8x8: 64 AND + (35 FA, 7 HA) typical + 10-bit CPA (4 stages)."""
    fa, ha = CELLS["fa"], CELLS["ha"]
    n_fa, n_ha = 35, 7
    area = 64 + n_fa * fa.area + n_ha * ha.area + 10 * fa.area
    energy = area
    # 4 CSA stages (FA sum delay each) + 10-bit ripple
    delay = 1.0 + 4 * fa.d_sum + 10 * fa.d_carry
    return {"area": area, "energy": energy, "delay": delay,
            "stages": 5, "pp_and_gates": 64.0}


def mult62_cost() -> Dict[str, float]:
    """Accurate multiplier by 6:2 compressors [38] (Table 3 baseline)."""
    # one 6:2 level (depth ~ 4:2 + FA) + 3:2 level + CPA; rough structural
    fa = CELLS["fa"]
    area = 64 + 8 * (3 * fa.area + 2 * CELLS["ha"].area) + 12 * fa.area
    delay = 1.0 + (fa.d_sum * 2 + 2) + fa.d_sum + 12 * fa.d_carry
    return {"area": area, "energy": area, "delay": delay,
            "stages": 4, "pp_and_gates": 64.0}


def pdp(cost: Dict[str, float]) -> float:
    return cost["energy"] * cost["delay"]


def pdap(cost: Dict[str, float]) -> float:
    return cost["energy"] * cost["delay"] * cost["area"]


def pdaep(cost: Dict[str, float], med: float) -> float:
    return pdap(cost) * med
