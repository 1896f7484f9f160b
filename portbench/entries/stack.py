"""The render loop's super-batch: one ``CRTEngine.process_stack`` call.

A call takes (n, B) frames in the engine's layout with their (n, B) frame
indices, the persistence state of the frames before them, and writes its
frames into a preallocated ``out``, as ``pipeline.render_stream`` calls it
at ``steps_per_call`` n.
"""

from portbench.entries import OneStream


class Entry(OneStream):
    def call(self, x, idx, state, out):
        _, state = self.engine.process_stack(x, idx, state, out=out)
        return state
