"""Host & process emulation layer (SURVEY.md §1 layer 5).

Phase-1 hosts run *plugin* workloads (Python apps over simulated sockets);
phase 4 adds real managed processes behind the same Host abstraction via the
native shim/IPC path (SURVEY.md §7 phase 4).
"""
