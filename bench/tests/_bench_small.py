"""A cell cut to a ring the CPU runs in seconds: log N 8, batches of 2, a
queue of 4 made from 2 base batches. The tolerance a slot is held to is loosened to 1e-3 of the
RMS: at 128 slots a row, the few slots near zeta = +-1 where the
rescale's rounding leaves its bias are a share of a row that the
configuration's tolerance, set for 32768 slots, does not allow for."""
from bench import cells

LOG_N = 8
SLOT_TOL = 1e-3


def small_cell(name: str, log_n: int = LOG_N, batch: int = 2):
    cell = cells.cell(name)
    cell["config"]["ckks"]["log_n"] = log_n
    cell["config"]["slot_tol"] = SLOT_TOL
    cell["traffic"]["batch"] = batch
    cell["traffic"]["pool"] = 2
    cell["traffic"]["queue"] = 4
    cell["traffic"]["checked"] = 2
    return cell
