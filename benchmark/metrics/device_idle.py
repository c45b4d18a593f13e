"""device_idle (the device, H100; the device trace): the share of the
device-only traced batch's wall in which no device operation ran."""


def read(r):
    return 100.0 * (1.0 - r.device.busy_s / r.device.wall_s)
