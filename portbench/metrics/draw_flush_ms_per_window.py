"""Host time resolving the draw plane's windows (``phase_wall.draw_flush``:
build, launch, wait and read of a card window, or the host's draw of a
window that stays there) per window it resolves: those sent to the card
(``device_windows_dispatched``) and those resolved on the host, which the
harness counts at ``colplane.loss_flags`` (record.py)."""


def read(window):
    done = [s for s in window.sims if s.summary]
    windows = sum(s.summary["device_windows_dispatched"] + s.host_windows
                  for s in done)
    if not windows:
        return None
    return 1e3 * sum(s.summary["phase_wall"]["draw_flush"]
                     for s in done) / windows
