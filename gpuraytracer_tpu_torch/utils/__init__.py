"""Host-side helpers of the port: device handling and ray accounting."""
