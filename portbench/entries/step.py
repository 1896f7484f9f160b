"""The render loop at one step per call: ``CRTEngine.process`` per batch.

As ``pipeline.render_stream`` runs under ``--segment-frames``: each batch of
B frames through ``process()``, its frames copied into the call's ``out``
(the render copies them to a host buffer), the state carried.
"""

from portbench.entries import OneStream


class Entry(OneStream):
    def call(self, x, idx, state, out):
        for i in range(self.steps):
            frames, state = self.engine.process(x[i], idx[i], state)
            out[i].copy_(frames, non_blocking=True)
        return state
