"""``structured.solve_structured_fast_carry``: a cold step without a carry,
else the carry init and K11 from the previous step's operators."""

from qpbench import program


class Entry(program.Entry):
    carries = True

    def prepare(self, ik):
        return program.structured_inputs(self.cfg, ik)

    def solve(self, args, carry=None):
        return program.program("structured").solve_structured_fast_carry(
            *args, carry, opt=self.opt, ir_steps=self.cfg["ir_steps"],
            backend=self.cfg["backend"])
