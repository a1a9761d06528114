"""The yardstick's least-work counts: each module gives, for one request of
a traffic mix, the operations and bytes the priced function cannot do
without, whatever kernel implements it."""
