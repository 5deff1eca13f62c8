"""Host-side serving runtime: paging, queue, scheduler, engine."""
