from pegasus_tpu_torch.redis_proxy.proxy import RedisHandler, RedisProxy

__all__ = ["RedisHandler", "RedisProxy"]
