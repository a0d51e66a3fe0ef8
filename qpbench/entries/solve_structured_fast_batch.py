"""``structured.solve_structured_fast_batch``: the structured factor
(K5+K6 for a tri-block-diagonal G), K11, refinement."""

from qpbench import program


class Entry(program.Entry):
    def prepare(self, ik):
        return program.structured_inputs(self.cfg, ik)

    def solve(self, args, carry=None):
        return program.program("structured").solve_structured_fast_batch(
            *args, opt=self.opt, ir_steps=self.cfg["ir_steps"],
            backend=self.cfg["backend"]), None
