"""The deterministic virtual machine identity — defined ONCE.

Every guest-visible surface derives from these: the sched_getaffinity
mask, sysinfo, the synthesized /proc/cpuinfo, /proc/meminfo and
/sys/devices/system/cpu files (native/vfs.py), and the uptime family.

SIM_CPUS is 1 ON PURPOSE: glibc treats nprocs>1 as SMP and spin-waits on
contended locks natively; under one-runnable-thread-at-a-time turn-taking
a spinner never yields and the lock holder never runs (reproduced with
CPython threading the moment /sys reported 2 CPUs). On one CPU every
contended lock futex-waits immediately — which is emulated."""

SIM_CPUS = 1
SIM_RAM = 2 << 30  # bytes; sysinfo reports 256 MB of it in use
