__version__ = '0.1.0'
__update_time__ = '2026-08-17'
