"""The port's kernel launches in the window (``propagate.LAUNCHES`` and
``mesh.LAUNCHES``, counted where each launch is made) per window the draw
plane sent to the card (``device_windows_dispatched``)."""


def read(window):
    done = [s.summary for s in window.sims if s.summary]
    windows = sum(s["device_windows_dispatched"] for s in done)
    launches = sum(window.launches.values())
    if not windows or not launches:
        return None
    return launches / windows
