from .devices import (all_devices, ndevices, select_device, device_props,
                      resolve)
from .timer import DeviceTimer, time_ms

__all__ = ["all_devices", "ndevices", "select_device", "device_props",
           "resolve", "DeviceTimer", "time_ms"]
